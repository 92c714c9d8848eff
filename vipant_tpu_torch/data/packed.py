"""Packed shards: contiguous memory-mapped batch storage (VA, AT, AudioSet).

The port's own copy of ``vipant_tpu/data/packed.py``, which a pack written by
either package reads identically in the other. Instead of one compressed npz
and one jpg *per clip*, a pack stores the whole split as flat memory-mapped
arrays:

- ``audio.npy``   [N, pack_len, M] normalised log-mel, the bits of its bf16
  rounding as uint16 (npy has no bf16 descr), pad rows the bits of the
  normalised zero
- ``lengths.npy`` [N] int32 true frame counts (the random temporal crop at
  train time needs them, as the npz path's crop does)
- ``image.npy``   [N, 3, res, res] uint8 deterministic CLIP crops (packed
  images trade the random-resized-crop augmentation for decode-free items)
- ``image_emb.npy`` [N, D] float32 (optional, the frame-embedding path)
- ``text.npy``    [N, k, ctx] int32 BPE caption tokens (audio_text packs),
  ``n_caps.npy`` [N] int32 each clip's true caption count
- ``label.npy``   [N, nlabel] float32 multi-hot (audioset packs)
- ``names.json`` / ``meta.json``

Items are zero-copy mmap slices and a whole batch assembles in one
vectorised gather (``get_batch``), which the loader submits as a single
pool task instead of B item tasks; SpecAugment masks apply in place on the
gathered batch. The audio stays uint16 all the way to the card, which views
it as ``torch.bfloat16`` (the trainer's ``audio_bf16_fbank`` branch): this
package does not need ``ml_dtypes``, whose bf16 rounding
:func:`.image_audio.bf16_bits` reproduces bitwise.

Normalisation is applied at PACK time (``meta.json`` records the norms; the
dataset refuses a config whose norms disagree), so the train-time audio path
is: slice + mask + ship. ``running.audio.ship_bf16`` must be on; the dataset
checks.

Three pack kinds (``meta.json["kind"]``): ``image_audio`` (VA pre-training,
:func:`pack_image_audio`), ``audio_text`` (AT fine-tuning,
:func:`pack_audio_text`) and ``audioset`` (AudioSet multi-label
classification, :func:`pack_audioset`; ``mixup_rate > 0`` is refused: the
reference mixes waveforms, `reference/cvap/data/audioset_cls.py:374-400`,
which a log-mel pack cannot reproduce).

Packing from wavs featurises through :func:`.transforms_audio.host_fbank`,
so the bytes of such a pack depend on whether the native fbank is built.

Usage::

    python -m vipant_tpu_torch.data.packed <overrides> [pack.kind=va|at|audioset] \\
        [pack.len=N] [pack.out=NAME] [pack.image_emb=true] [pack.log_every=N]
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

PACK_VERSION = 1


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bits -> float32 (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def _scalar_bits(v) -> np.uint16:
    """The bits of a scalar's bf16 rounding."""
    from .image_audio import bf16_bits

    return bf16_bits(np.full((1,), v, np.float32))[0]


def _ordered_label_ids(label_map: Dict) -> List:
    """Label ids in index order — recorded at pack time and re-derived at
    load time; the two must come from THIS one function so the order check
    in ``AudiosetDatasetPak`` stays meaningful."""
    ordered = [None] * len(label_map)
    for lid, v in label_map.items():
        ordered[v[0]] = lid
    return ordered


def _pad_value(norms) -> np.float32:
    # pad rows carry the NORMALIZED-zero value: every dataset path (npz and
    # src) pads the raw fbank with zeros BEFORE normalizing (`image_audio.py`
    # `_audio`), so (0-mean)/std is what a trained checkpoint has seen in
    # pad regions — literal 0.0 would silently feed a different pad
    # distribution to short clips
    return (
        np.float32((0.0 - norms[0]) / norms[1]) if norms is not None else np.float32(0.0)
    )


def _write_audio_row(audio_mm, lengths, i, aclip_file, pack_len, norms, acfg, params, pad_val):
    """One clip's normalized log-mel row into the pack: raw npz fbank if
    present (the reference's throughput convention), else featurize the wav
    with eval semantics. Shared by every pack builder."""
    from .image_audio import bf16_bits
    from .transforms_audio import extract_fbank_features

    stem = aclip_file.rsplit(".", 1)[0]
    if os.path.exists(stem + ".npz"):
        data = np.load(stem + ".npz")
        key = "feat" if "feat" in data.files else data.files[0]
        feats = data[key].astype(np.float32, copy=False)[:pack_len]
        if norms is not None:
            feats = (feats - np.float32(norms[0])) / np.float32(norms[1])
        lengths[i] = feats.shape[0]
        audio_mm[i, : feats.shape[0]] = bf16_bits(feats)
        if feats.shape[0] < pack_len:
            audio_mm[i, feats.shape[0] :] = _scalar_bits(pad_val)
        return
    from .wav import read_wav

    wav, sr = read_wav(aclip_file)
    tile = bool(acfg.get("tile_audio", False))
    feats = extract_fbank_features(
        (wav, sr), params, max_audio_len=pack_len, train=False,
        zero_mean_wf=bool(acfg.get("zero_mean_wf", True)),
        tile_audio=tile,
        norms=norms,
    )
    if tile:
        # tiling fills pack_len with real (repeated) content — all rows are
        # croppable, none are padding
        lengths[i] = pack_len
    else:
        # true (un-padded) frame count from the wav duration
        shift = int(sr * float(acfg.get("frame_shift", 10)) / 1000)
        win = int(sr * float(acfg.get("frame_length", 25)) / 1000)
        nf = max((wav.shape[-1] - win) // shift + 1, 0)
        lengths[i] = min(nf, pack_len)
    audio_mm[i] = bf16_bits(feats)


def _write_meta(out_dir, kind, n, pack_len, mel, norms, names, extra=None):
    with open(os.path.join(out_dir, "names.json"), "w") as f:
        json.dump(names, f)
    meta = {
        "version": PACK_VERSION,
        "kind": kind,
        "n": n,
        "pack_len": pack_len,
        "mel": mel,
        "norms": list(norms) if norms is not None else None,
        "audio_dtype": "bfloat16",
    }
    meta.update(extra or {})
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


def pack_image_audio(
    run_cfg,
    data_name: str,
    pack_len: Optional[int] = None,
    out_name: Optional[str] = None,
    image_emb: bool = False,
    log_every: int = 0,
) -> str:
    """Stream ``{data_root}/{data_name}.jsonl`` into ``{out_name}.pak/``.

    ``pack_len`` defaults to ``max_audio_len``; choose it LARGER to keep
    the npz path's random-temporal-crop augmentation (e.g. the reference
    packs 10.24 s clips and trains on 10.00 s windows). Audio records may
    be precomputed-fbank npz (a ``.npz`` next to the aclip path, the npz
    dataset's convention) or raw wav (featurized here, eval semantics).
    Images pack as deterministic CLIP crops. Memory use is O(1): arrays
    stream through ``np.lib.format.open_memmap``.
    """
    from .image_audio import ImageAudioDatasetSrc
    from .transforms_image import clip_preprocess_uint8
    from PIL import Image as PILImage

    ds = ImageAudioDatasetSrc(run_cfg, data_name, train=False)
    n = len(ds.records)
    pack_len = int(pack_len or run_cfg.max_audio_len)
    mel = int(run_cfg.audio.get("num_mel_bins", 128))
    res = int(run_cfg.get("resolution", 224))
    norms = ds.norms
    out_name = out_name or f"pak_{data_name}"
    out_dir = os.path.join(run_cfg.data_root, f"{out_name}.pak")
    os.makedirs(out_dir, exist_ok=True)

    audio_mm = np.lib.format.open_memmap(
        os.path.join(out_dir, "audio.npy"), mode="w+",
        dtype=np.uint16, shape=(n, pack_len, mel),
    )
    image_mm = np.lib.format.open_memmap(
        os.path.join(out_dir, "image.npy"), mode="w+",
        dtype=np.uint8, shape=(n, 3, res, res),
    )
    lengths = np.zeros((n,), np.int32)
    emb_mm = None
    names: List[str] = []
    pad_val = _pad_value(norms)

    for i in range(n):
        name, aclip_file, frame_file, frame_emb_file = ds._paths(i)
        names.append(name)
        _write_audio_row(
            audio_mm, lengths, i, aclip_file, pack_len, norms, ds.acfg,
            ds.params, pad_val,
        )
        # ---- image: deterministic CLIP crop, uint8 ---------------------
        if frame_file is not None:
            try:
                img = PILImage.open(frame_file)
                image_mm[i] = clip_preprocess_uint8(img, res)
            except Exception:
                pass  # corrupt → zeros (the dataset's random-image analogue)
        if image_emb and frame_emb_file is not None:
            v = np.load(frame_emb_file)["v"].astype(np.float32)
            if emb_mm is None:
                emb_mm = np.lib.format.open_memmap(
                    os.path.join(out_dir, "image_emb.npy"), mode="w+",
                    dtype=np.float32, shape=(n, v.shape[-1]),
                )
            emb_mm[i] = v
        if log_every and (i + 1) % log_every == 0:
            print(f"packed {i + 1}/{n}", flush=True)

    np.save(os.path.join(out_dir, "lengths.npy"), lengths)
    _write_meta(
        out_dir, "image_audio", n, pack_len, mel, norms, names,
        extra={
            "resolution": res,
            "has_image_emb": emb_mm is not None,
            "source": data_name,
        },
    )
    audio_mm.flush()
    image_mm.flush()
    if emb_mm is not None:
        emb_mm.flush()
    return out_dir


def pack_audio_text(
    run_cfg,
    model_cfg,
    data_name: str,
    pack_len: Optional[int] = None,
    out_name: Optional[str] = None,
    log_every: int = 0,
) -> str:
    """Pack an audio-text split (Clotho CSV / AudioCaps JSONL): bf16 log-mel
    rows + the k BPE-tokenized captions per clip ([N, k, ctx] int32, short
    lists padded cyclically like ``AudioTextDatasetSrc.eval_k``). The AT
    fine-tune — the gradient-cache flagship — gets the same one-gather
    batch fast path as the VA packs (VERDICT r4 #6)."""
    from .audio_text import build_audiocaps_list, build_clotho_list

    prompt = str(run_cfg.get("prompt", "") or "")
    if data_name.startswith("clotho"):
        records = build_clotho_list(run_cfg, data_name, prompt)
    else:
        records = build_audiocaps_list(run_cfg, data_name, prompt)
    n = len(records)
    pack_len = int(pack_len or run_cfg.max_audio_len)
    mel = int(run_cfg.audio.get("num_mel_bins", 128))
    ctx = int(model_cfg.text.get("ctx_len", 77)) if "text" in model_cfg else 77
    k = max((len(r["captions_bpe"]) for r in records), default=1)
    from .image_audio import fbank_params_from_cfg

    acfg = run_cfg.audio
    params = fbank_params_from_cfg(acfg)
    norms = tuple(acfg.get("norms", []) or []) or None
    out_name = out_name or f"pak_{data_name}"
    out_dir = os.path.join(run_cfg.data_root, f"{out_name}.pak")
    os.makedirs(out_dir, exist_ok=True)

    audio_mm = np.lib.format.open_memmap(
        os.path.join(out_dir, "audio.npy"), mode="w+",
        dtype=np.uint16, shape=(n, pack_len, mel),
    )
    text_mm = np.lib.format.open_memmap(
        os.path.join(out_dir, "text.npy"), mode="w+",
        dtype=np.int32, shape=(n, k, ctx),
    )
    lengths = np.zeros((n,), np.int32)
    n_caps = np.zeros((n,), np.int32)
    names: List[str] = []
    pad_val = _pad_value(norms)

    for i, rec in enumerate(records):
        names.append(rec["id"])
        sub = rec.get("dir", "")
        path = os.path.join(run_cfg.data_root, sub, "aclip", rec["aclip"])
        if not os.path.exists(path):
            path = os.path.join(run_cfg.data_root, sub, rec["aclip"])
        _write_audio_row(
            audio_mm, lengths, i, path, pack_len, norms, acfg, params,
            pad_val,
        )
        caps = rec["captions_bpe"]
        # true caption count: train-time picks must be uniform over the
        # REAL captions, not over the k cyclically-padded slots (a 3-cap
        # clip in a k=5 pack would otherwise see caps 0/1 at p=2/5 and
        # cap 2 at p=1/5 — a different distribution than the src path)
        n_caps[i] = min(len(caps), k)
        for j in range(k):
            toks = caps[j % len(caps)][:ctx]
            text_mm[i, j, : len(toks)] = toks
        if log_every and (i + 1) % log_every == 0:
            print(f"packed {i + 1}/{n}", flush=True)

    np.save(os.path.join(out_dir, "lengths.npy"), lengths)
    np.save(os.path.join(out_dir, "n_caps.npy"), n_caps)
    _write_meta(
        out_dir, "audio_text", n, pack_len, mel, norms, names,
        extra={"k": k, "ctx_len": ctx, "source": data_name, "prompt": prompt},
    )
    audio_mm.flush()
    text_mm.flush()
    return out_dir


def pack_audioset(
    run_cfg,
    data_name: str,
    label_map: Dict,
    pack_len: Optional[int] = None,
    out_name: Optional[str] = None,
    log_every: int = 0,
) -> str:
    """Pack an AudioSet clf split: bf16 log-mel + uint8 CLIP image crops +
    [N, nlabel] float32 multi-hot labels in label-map (ontology) order.
    The label id list is recorded in meta.json; the dataset refuses a
    label map whose order disagrees (silently permuted labels would train
    on shuffled targets)."""
    from .audioset import AudiosetSrc
    from .transforms_image import clip_preprocess_uint8
    from PIL import Image as PILImage

    ds = AudiosetSrc(run_cfg, data_name, train=False, label_map=label_map, clf=True)
    n = len(ds.records)
    pack_len = int(pack_len or run_cfg.max_audio_len)
    mel = int(run_cfg.audio.get("num_mel_bins", 128))
    res = int(run_cfg.get("resolution", 224))
    norms = ds.norms
    out_name = out_name or f"pak_{data_name}"
    out_dir = os.path.join(run_cfg.data_root, f"{out_name}.pak")
    os.makedirs(out_dir, exist_ok=True)

    audio_mm = np.lib.format.open_memmap(
        os.path.join(out_dir, "audio.npy"), mode="w+",
        dtype=np.uint16, shape=(n, pack_len, mel),
    )
    image_mm = np.lib.format.open_memmap(
        os.path.join(out_dir, "image.npy"), mode="w+",
        dtype=np.uint8, shape=(n, 3, res, res),
    )
    label_mm = np.lib.format.open_memmap(
        os.path.join(out_dir, "label.npy"), mode="w+",
        dtype=np.float32, shape=(n, len(label_map)),
    )
    lengths = np.zeros((n,), np.int32)
    names: List[str] = []
    pad_val = _pad_value(norms)
    # label ids in index order, for the load-time order check
    ordered = _ordered_label_ids(label_map)

    for i in range(n):
        name, aclip_file, frame_file, _ = ds._paths(i)
        names.append(name)
        _write_audio_row(
            audio_mm, lengths, i, aclip_file, pack_len, norms, ds.acfg,
            ds.params, pad_val,
        )
        if frame_file is not None:
            try:
                img = PILImage.open(frame_file)
                image_mm[i] = clip_preprocess_uint8(img, res)
            except Exception:
                pass
        label_mm[i] = ds._label_vector(ds.records[i])
        if log_every and (i + 1) % log_every == 0:
            print(f"packed {i + 1}/{n}", flush=True)

    np.save(os.path.join(out_dir, "lengths.npy"), lengths)
    _write_meta(
        out_dir, "audioset", n, pack_len, mel, norms, names,
        extra={"resolution": res, "label_ids": ordered, "source": data_name},
    )
    audio_mm.flush()
    image_mm.flush()
    label_mm.flush()
    return out_dir


class _PakAudioBase:
    """Shared audio side of the packed datasets: mmap open + re-open on
    unpickle, config guards, and the vectorized bf16 audio gather with
    per-batch-seeded temporal crop + in-place SpecAugment."""

    KIND = ""
    _ARRAY_ATTRS = ("audio",)

    def __init__(self, cfg, data_name: str, train: bool):
        self.cfg = cfg
        self.train = train
        d = os.path.join(cfg.data_root, f"{data_name}.pak")
        self._dir = d
        with open(os.path.join(d, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta.get("version") != PACK_VERSION:
            raise ValueError(f"pack version {self.meta.get('version')} != {PACK_VERSION}")
        kind = self.meta.get("kind", "image_audio")
        if kind != self.KIND:
            raise ValueError(f"pack kind {kind!r} != expected {self.KIND!r}")
        self._open_arrays()
        self.lengths = np.load(os.path.join(d, "lengths.npy"))
        with open(os.path.join(d, "names.json")) as f:
            self.names = json.load(f)

        acfg = cfg.audio
        self.max_len = int(cfg.max_audio_len)
        self.pack_len = int(self.meta["pack_len"])
        # norms were baked in at pack time — a config that disagrees would
        # silently train on differently-scaled features
        cfg_norms = tuple(acfg.get("norms", []) or []) or None
        pak_norms = self.meta.get("norms")
        if cfg_norms is not None and pak_norms is not None:
            if not np.allclose(cfg_norms, pak_norms, atol=1e-6):
                raise ValueError(
                    f"pack norms {pak_norms} != running.audio.norms {list(cfg_norms)}"
                )
        # packed audio ships bf16; the trainer's device frontend upcasts
        # only when the flag is on — fail loud instead of feeding bf16 to
        # a path that expects f32
        if not bool(acfg.get("ship_bf16", False)):
            raise ValueError("packed datasets require running.audio.ship_bf16=True")
        from .transforms_audio import make_transform

        self.transform_fbank = make_transform(acfg)[1] if train else None
        n = pak_norms if pak_norms is not None else cfg_norms
        self._pad_val = (
            np.float32((0.0 - n[0]) / n[1]) if n is not None else np.float32(0.0)
        )
        # eval cap retained on the instance so builders that FILTER records
        # (audioset filter_set) can re-apply it after filtering — filter
        # must precede the cap to match the src path's filter-at-init /
        # cap-at-iteration order
        from .indexfile import eval_sample_limit

        self.eval_limit = None if train else eval_sample_limit(cfg.get("eval_samples"))
        self.records = list(range(self.meta["n"]))[: self.eval_limit]

    def _open_arrays(self) -> None:
        # uint16 bf16 bits; the card views them as bf16
        self.audio = np.load(os.path.join(self._dir, "audio.npy"), mmap_mode="r")

    # process-backend workers receive the dataset by pickle: ship the pack
    # PATH and reopen the mmaps in the worker — pickling an np.memmap
    # materializes the whole array into the pickle stream (a production
    # pack is tens of GB; zero-copy is the point of the format)
    def __getstate__(self):
        state = dict(self.__dict__)
        for k in self._ARRAY_ATTRS:
            state.pop(k, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._open_arrays()

    def __len__(self) -> int:
        return len(self.records)

    # ------------------------------------------------------------- items
    def _mask_inplace(self, feats: np.ndarray, rng) -> None:
        """SpecAugment on the [T, M] slice of the batch buffer (the npz
        path's post-normalization mask semantics, zero fill) without the
        generic transforms' defensive copies. ``feats`` holds bf16 bits: the
        zero fill is bf16 +0, and a generic transform runs on their fp32
        values, its result rounded back to bf16 bits."""
        from .image_audio import bf16_bits
        from .transforms_audio import FrequencyMasking, TimeMasking

        for t in self.transform_fbank or []:
            if isinstance(t, FrequencyMasking):
                width = rng.uniform(0.0, t.mask_param)
                start = rng.uniform(0.0, max(feats.shape[1] - width, 0))
                feats[:, int(start) : int(start + width)] = 0
            elif isinstance(t, TimeMasking):
                width = rng.uniform(0.0, t.mask_param)
                start = rng.uniform(0.0, max(feats.shape[0] - width, 0))
                feats[int(start) : int(start + width), :] = 0
            else:  # unknown transform: generic callable (f32 round trip)
                feats[...] = bf16_bits(t(_bf16_to_f32(feats)))

    def _start(self, row: int, rng=np.random) -> int:
        span = int(self.lengths[row]) - self.max_len
        if self.train and span > 0:
            return int(rng.integers(0, span + 1)) if hasattr(rng, "integers") else int(
                rng.randint(0, span + 1)
            )
        return 0

    def _gather_audio(self, rows: Sequence[int], rng) -> np.ndarray:
        """[B, 1, max_len, M] bf16 bits (uint16): one vectorized mmap gather
        with the per-row temporal crop and in-place masks."""
        B = len(rows)
        if self.max_len <= self.pack_len:
            audio = np.empty((B, 1, self.max_len, self.audio.shape[-1]), self.audio.dtype)
        else:
            # rows shorter than max_len: fill with the normalized-zero pad
            # value the disk rows use (see _write_audio_row)
            audio = np.full(
                (B, 1, self.max_len, self.audio.shape[-1]),
                _scalar_bits(self._pad_val),
                self.audio.dtype,
            )
        for k, row in enumerate(rows):
            s = self._start(row, rng)
            src = self.audio[row, s : s + self.max_len]
            audio[k, 0, : src.shape[0]] = src
            if self.transform_fbank:
                self._mask_inplace(audio[k, 0], rng)
        return audio

    def _batch_rng(self, seed: Optional[int]):
        """``seed`` makes the batch's augmentations (crop windows, masks,
        caption picks) reproducible regardless of worker backend or
        scheduling — the loader derives one per batch from (loader seed,
        epoch, position), so pak runs replay exactly across restarts and
        mid-epoch resumes even with thread workers (the per-item paths only
        achieve this with process workers)."""
        return np.random.default_rng(seed) if seed is not None else np.random


class ImageAudioDatasetPak(_PakAudioBase):
    """Zero-copy packed VA dataset with a vectorized ``get_batch`` the
    loader uses as a one-task-per-batch fast path."""

    KIND = "image_audio"
    _ARRAY_ATTRS = ("audio", "image", "image_emb")

    def __init__(self, cfg, data_name: str, train: bool):
        self._want_emb = cfg.get("frame_emb") is not None
        super().__init__(cfg, data_name, train)
        if self.image_emb is None and not bool(cfg.get("image_uint8", False)):
            raise ValueError("packed datasets require running.image_uint8=True")

    def _open_arrays(self) -> None:
        super()._open_arrays()
        self.image = np.load(os.path.join(self._dir, "image.npy"), mmap_mode="r")
        emb_path = os.path.join(self._dir, "image_emb.npy")
        self.image_emb = (
            np.load(emb_path, mmap_mode="r")
            if self._want_emb and os.path.exists(emb_path)
            else None
        )

    def get_batch(self, idxs: Sequence[int], seed: Optional[int] = None) -> Dict[str, Any]:
        """Assemble a collated batch straight from the mmaps: one bf16
        audio gather (+ in-place masks) and one uint8 image gather."""
        rng = self._batch_rng(seed)
        rows = [self.records[int(i)] for i in idxs]
        out: Dict[str, Any] = {
            "audio": self._gather_audio(rows, rng),
            "name": [self.names[r] for r in rows],
        }
        if self.image_emb is not None:
            out["image"] = np.asarray(self.image_emb[rows], np.float32)
        else:
            out["image"] = np.asarray(self.image[rows])  # uint8 gather
        return out

    def __getitem__(self, index: int) -> Dict[str, Any]:
        """Single-item path (collator-compatible shapes) so the pak
        dataset also works wherever items are consumed one by one."""
        b = self.get_batch([index])
        return {
            "image": b["image"][0],
            "audio": b["audio"][0, 0],
            "name": b["name"][0],
        }


class AudioTextDatasetPak(_PakAudioBase):
    """Packed AT dataset (`pack_audio_text`): train picks a (seeded) random
    caption per item, eval flattens all k captions to [B*k, ctx] — the
    exact semantics of ``AudioTextDatasetSrc``/``AudioTextCollator``."""

    KIND = "audio_text"
    _ARRAY_ATTRS = ("audio", "text")

    def __init__(self, cfg, data_name: str, train: bool):
        super().__init__(cfg, data_name, train)
        # the prompt is baked into the packed tokens — a config that
        # disagrees would silently train/eval on different text than it
        # states (ctx_len and norms mismatches on this path already raise).
        # Packs written before the prompt was recorded can't be checked —
        # warn instead of guessing their pack-time prompt was ""
        cfg_prompt = str(cfg.get("prompt", "") or "")
        if "prompt" in self.meta:
            pak_prompt = str(self.meta.get("prompt") or "")
            if cfg_prompt != pak_prompt:
                raise ValueError(
                    f"pack prompt {pak_prompt!r} != running.prompt "
                    f"{cfg_prompt!r} — repack or fix the config"
                )
        else:  # legacy packs only
            import warnings

            warnings.warn(
                f"pack {self._dir} predates prompt recording — cannot "
                f"verify it matches running.prompt {cfg_prompt!r}; repack "
                "to enable the check",
                stacklevel=2,
            )
        # true caption counts (uniform train picks over REAL captions, not
        # the cyclically-padded slots); packs written before n_caps.npy
        # existed fall back to all-k (the old, slot-uniform behavior)
        p = os.path.join(self._dir, "n_caps.npy")
        self.n_caps = (
            np.load(p)
            if os.path.exists(p)
            else np.full((self.meta["n"],), self.text.shape[1], np.int32)
        )
        # random-caption baseline: caption ROWS permuted across clips, the
        # pak analogue of the src path's record-level caption swap
        # (parity: `reference/cvap/data/audiocaps.py:64,105-110`)
        self._cap_row = None
        if bool(cfg.get("np_rnd", False)):
            self._cap_row = np.random.permutation(self.meta["n"])

    def _open_arrays(self) -> None:
        super()._open_arrays()
        self.text = np.load(os.path.join(self._dir, "text.npy"), mmap_mode="r")

    def get_batch(self, idxs: Sequence[int], seed: Optional[int] = None) -> Dict[str, Any]:
        rng = self._batch_rng(seed)
        rows = [self.records[int(i)] for i in idxs]
        audio = self._gather_audio(rows, rng)
        crows = rows if self._cap_row is None else [int(self._cap_row[r]) for r in rows]
        if self.train:
            nc = self.n_caps[crows]
            u = (
                rng.random(size=len(rows))
                if hasattr(rng, "integers")
                else rng.random_sample(size=len(rows))
            )
            picks = (u * nc).astype(np.int64)  # uniform over REAL captions
            text = np.stack(
                [self.text[row, int(p)] for row, p in zip(crows, picks)]
            ).astype(np.int32)
        else:
            text = np.asarray(self.text[crows], np.int32).reshape(-1, self.text.shape[-1])
        return {
            "audio": audio,
            "text": text,
            "name": [self.names[r] for r in rows],
        }

    def __getitem__(self, index: int) -> Dict[str, Any]:
        b = self.get_batch([index])
        return {
            "audio": b["audio"][0, 0],
            "text": b["text"][0] if self.train else b["text"].reshape(
                self.text.shape[1], -1
            ),
            "name": b["name"][0],
        }


class AudiosetDatasetPak(_PakAudioBase):
    """Packed AudioSet clf dataset (`pack_audioset`). Refuses mixup (the
    reference mixes WAVEFORMS before the fbank; a log-mel pack cannot
    reproduce that — keep the npz/src path for mixup recipes) and label
    maps whose order differs from pack time."""

    KIND = "audioset"
    _ARRAY_ATTRS = ("audio", "image", "label")

    def __init__(self, cfg, data_name: str, train: bool, label_map: Dict):
        super().__init__(cfg, data_name, train)
        if not bool(cfg.get("image_uint8", False)):
            raise ValueError("packed datasets require running.image_uint8=True")
        if train and float(cfg.get("mixup_rate", 0.0)) > 0:
            raise ValueError(
                "mixup_rate > 0 is not supported on packed AudioSet shards "
                "(reference mixup operates on waveforms; use the npz/src path)"
            )
        if _ordered_label_ids(label_map) != self.meta.get("label_ids"):
            raise ValueError(
                "label map order differs from pack time — repack or fix the "
                "ontology/label_map config"
            )

    def _open_arrays(self) -> None:
        super()._open_arrays()
        self.image = np.load(os.path.join(self._dir, "image.npy"), mmap_mode="r")
        self.label = np.load(os.path.join(self._dir, "label.npy"), mmap_mode="r")

    def get_batch(self, idxs: Sequence[int], seed: Optional[int] = None) -> Dict[str, Any]:
        rng = self._batch_rng(seed)
        rows = [self.records[int(i)] for i in idxs]
        return {
            "audio": self._gather_audio(rows, rng),
            "image": np.asarray(self.image[rows]),  # uint8 gather
            "label": np.asarray(self.label[rows], np.float32),
            "name": [self.names[r] for r in rows],
        }

    def __getitem__(self, index: int) -> Dict[str, Any]:
        b = self.get_batch([index])
        return {
            "image": b["image"][0],
            "audio": b["audio"][0, 0],
            "label": b["label"][0],
            "name": b["name"][0],
        }


def main(argv: Optional[List[str]] = None) -> None:
    """``python -m vipant_tpu_torch.data.packed <compose overrides> [pack.len=N]
    [pack.out=NAME] [pack.image_emb=true] [pack.kind=va|at|audioset]`` —
    pack ``running.data_name``. ``pack.kind`` defaults by monitor: LAMonitor
    -> at, ASMonitor -> audioset, else va."""
    import sys

    from ..config import compose

    args = list(sys.argv[1:] if argv is None else argv)
    cfg = compose(args)
    pack = cfg.get("pack", None)
    get = (lambda k, d=None: pack.get(k, d)) if pack is not None else (lambda k, d=None: d)
    kind = get("kind") or {
        "LAMonitor": "at", "ASMonitor": "audioset"
    }.get(str(cfg.get("monitor", "")), "va")
    if kind == "at":
        out = pack_audio_text(
            cfg.running, cfg.model, str(cfg.running.data_name),
            pack_len=get("len"), out_name=get("out"),
            log_every=int(get("log_every", 1000)),
        )
    elif kind == "audioset":
        from .audioset import build_audioset_label_map

        out = pack_audioset(
            cfg.running, str(cfg.running.data_name),
            build_audioset_label_map(cfg.running),
            pack_len=get("len"), out_name=get("out"),
            log_every=int(get("log_every", 1000)),
        )
    else:
        out = pack_image_audio(
            cfg.running,
            str(cfg.running.data_name),
            pack_len=get("len"),
            out_name=get("out"),
            image_emb=bool(get("image_emb", False)),
            log_every=int(get("log_every", 1000)),
        )
    print(out)


if __name__ == "__main__":
    main()
