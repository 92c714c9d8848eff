"""X-fold classification datasets: ESC-50 (5-fold), UrbanSound8K (10-fold),
AudioSet eval, VoxCeleb2 — plus zero-shot label maps.

The port's own copy of ``vipant_tpu/data/esc50.py`` (the same records,
classes, prompts and items; the wav items featurise through
:func:`.transforms_audio.host_fbank`). :func:`build_xfold_dataloader_list`
also takes the trainer's ``device_put_fn`` for the training loaders.

Parity with `reference/cvap/data/esc50.py`: fold splits from the
standard metadata CSVs, per-class prompt texts ("the sound of …") BPE-ready
for zero-shot, and the ``build_xfold_dataloader_list`` dispatcher
(`:448-458`).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..tokenizer import tokenize
from .image_audio import fbank_params_from_cfg
from .indexfile import eval_sample_limit, load_csv, load_jsonl
from .loader import DataLoader
from .transforms_audio import extract_fbank_features, make_transform


class AudioLabelDataset:
    """wav + integer label items
    (parity: `reference/cvap/data/esc50.py:28-111`)."""

    def __init__(self, cfg, records: List[Dict], train: bool):
        self.cfg = cfg
        self.records = records
        self.train = train
        acfg = cfg.audio
        self.acfg = acfg
        self.params = fbank_params_from_cfg(acfg)
        self.norms = tuple(acfg.get("norms", []) or []) or None
        self.transform_audio, self.transform_fbank = make_transform(acfg)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, index: int) -> Dict:
        rec = self.records[index]
        audio = extract_fbank_features(
            rec["path"],
            self.params,
            max_audio_len=int(self.cfg.max_audio_len),
            train=self.train,
            zero_mean_wf=bool(self.acfg.get("zero_mean_wf", True)),
            tile_audio=bool(self.acfg.get("tile_audio", True)),
            transform_audio=self.transform_audio if self.train else None,
            norms=self.norms,
            transform_fbank=self.transform_fbank if self.train else None,
        )
        label = rec["label"]
        label = label if isinstance(label, np.ndarray) else int(label)  # multi-hot (AudioSet) or int
        return {"audio": audio, "label": label, "name": rec["id"]}


class AudioLabelCollator:
    def __call__(self, items: List[Dict]) -> Dict[str, np.ndarray]:
        return {
            "audio": np.stack([it["audio"] for it in items]).astype(np.float32, copy=False)[:, None],
            "label": np.asarray([it["label"] for it in items], np.int32),
            "name": [it["name"] for it in items],
        }


class MReserveDataset:
    """MERLOT-Reserve comparison items — the reference's optional external
    A/B path (parity: `reference/cvap/data/esc50.py:129-192`): each
    clip is segmented and preprocessed by the `mreserve` package into the
    video-segment format a MERLOT-Reserve model scores, with the zero-shot
    prompt text injected as segment 0. The package is an optional external
    dependency, guarded exactly like the reference's try/ImportError
    (`:23-26`); without it this dataset fails loudly at first use with the
    recorded decision (mreserve and its TF weights are not vendored)."""

    def __init__(self, cfg, records: List[Dict], train: bool):
        self.cfg = cfg
        self.records = records
        self.train = train
        self.acfg = cfg.audio

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, index: int) -> Dict:
        try:
            from mreserve.preprocess import preprocess_video, video_to_segments
        except ImportError as e:  # pragma: no cover - exercised via fake module
            raise ImportError(
                "the mreserve comparison path needs the optional "
                "`mreserve` package (MERLOT-Reserve) — not vendored; see "
                "docs/recipes.md decision records"
            ) from e
        rec = self.records[index]
        a = self.acfg
        segments = video_to_segments(
            rec["path"],
            end_trim=a.get("end_trim", 0.0),
            segment_gap=a.get("segment_gap", 0.0),
            pad_segment=a.get("pad_segment", True),
            min_duration=a.get("min_duration", 1.0),
            time_interval=a.get("time_interval", 1.0),
            tile_length=a.get("tile_length", 1.0),
        )[:7]
        import copy as _copy

        segments.insert(0, _copy.deepcopy(segments[0]))
        segments[0]["text"] = str(self.cfg.get("text", ""))
        segments[0]["use_text_as_input"] = True
        for seg in segments[1:]:
            seg["use_text_as_input"] = False
        assert len(segments) >= 2, "require at least 2 video segments"
        video = preprocess_video(
            segments,
            output_grid_size=a.get("grid_size", None),
            verbose=bool(a.get("verbose", False)),
        )
        return {
            "video": video,
            "audio": np.array([[[1]]], np.float32),  # placeholder, ref :148
            "label": int(rec["label"]),
            "name": rec["id"],
        }


class MReserveCollator:
    """(parity: `reference/cvap/data/esc50.py:185-192`) — videos stay
    a list (ragged segment counts); audio is the reference's placeholder."""

    def __call__(self, items: List[Dict]) -> Dict:
        return {
            "audio": np.concatenate([it["audio"] for it in items], axis=0),
            "label": np.asarray([it["label"] for it in items], np.int32),
            "name": [it["name"] for it in items],
            "video": [it["video"] for it in items],
        }


def _prompted_label_texts(
    cfg, classes: List[str], topk: int = 4
) -> Tuple[List[str], np.ndarray, Optional[Dict[int, int]]]:
    """Zero-shot label texts with optional multi-prompt expansion.

    When ``{data_root}/meta/{prompt}.json`` exists it maps each class name
    to a list of prompt rewrites; the first ``topk`` are kept per class
    (with the image-prompt prefix "a photo of" rewritten to "the sound of")
    and a ``label_map`` {prompt row -> class id} collapses predictions
    (parity: `reference/cvap/data/esc50.py:258-276`). Otherwise one
    "{prompt} {class}" text per class and no map."""
    import json as _json
    import re as _re

    prompt = str(cfg.get("prompt", "") or "").strip()
    label_path = os.path.join(str(cfg.data_root), "meta", f"{prompt}.json")
    if prompt and os.path.isfile(label_path):
        with open(label_path) as f:
            by_class = _json.load(f)
        texts: List[str] = []
        for c in classes:
            variants = by_class[c.replace("_", " ")][:topk]
            assert len(variants) == topk, (
                f"unbalanced label mapping for `{c}`: want {topk}, got {len(variants)}"
            )
            texts.extend(_re.sub("^a photo of", "the sound of", t) for t in variants)
        label_map = {i: i // topk for i in range(len(classes) * topk)}
        return texts, tokenize(texts), label_map
    pfx = "" if prompt == "" else prompt + " "
    texts = [f"{pfx}{c.replace('_', ' ')}" for c in classes]
    return texts, tokenize(texts), None


def build_esc50_folds(cfg, data_name: str = "esc50"):
    """5-fold ESC-50 from the standard meta CSV (filename, fold, target,
    category) (parity: `reference/cvap/data/esc50.py:224-276`).
    Returns (folds, classes, label_ids) where folds[i] =
    (train_records, eval_records) holding fold i+1 out."""
    meta = load_csv(os.path.join(cfg.data_root, f"{data_name}.csv"))
    classes: Dict[int, str] = {}
    records = []
    for row in meta:
        target = int(row["target"])
        classes[target] = row["category"]
        records.append(
            {
                "id": row["filename"].rsplit(".", 1)[0],
                "path": os.path.join(cfg.data_root, "audio", row["filename"]),
                "label": target,
                "fold": int(row["fold"]),
            }
        )
    class_list = [classes[i] for i in sorted(classes)]
    texts, label_ids, label_map = _prompted_label_texts(cfg, class_list)
    nfold = max(r["fold"] for r in records)
    folds = []
    for f in range(1, nfold + 1):
        train = [r for r in records if r["fold"] != f]
        evals = [r for r in records if r["fold"] == f]
        folds.append((train, evals))
    return folds, class_list, label_ids, {"label_map": label_map}


def build_us8k_folds(cfg, data_name: str = "us8k"):
    """UrbanSound8K 10-fold from UrbanSound8K.csv (slice_file_name, fold,
    classID, class) (parity: `reference/cvap/data/esc50.py:278-324`)."""
    meta = load_csv(os.path.join(cfg.data_root, f"{data_name}.csv"))
    classes: Dict[int, str] = {}
    records = []
    for row in meta:
        cid = int(row["classID"])
        classes[cid] = row["class"]
        fold = int(row["fold"])
        records.append(
            {
                "id": row["slice_file_name"].rsplit(".", 1)[0],
                "path": os.path.join(cfg.data_root, "audio", f"fold{fold}", row["slice_file_name"]),
                "label": cid,
                "fold": fold,
            }
        )
    class_list = [classes[i] for i in sorted(classes)]
    texts, label_ids, label_map = _prompted_label_texts(cfg, class_list)
    nfold = max(r["fold"] for r in records)
    folds = [
        (
            [r for r in records if r["fold"] != f],
            [r for r in records if r["fold"] == f],
        )
        for f in range(1, nfold + 1)
    ]
    return folds, class_list, label_ids, {"label_map": label_map}


def build_jsonl_eval_fold(cfg, data_name: str):
    """Single-fold eval set from a generic JSONL index with a ``class``
    field — the catch-all for ad-hoc eval sets."""
    rows = load_jsonl(os.path.join(cfg.data_root, f"{data_name}.jsonl"))
    classes = sorted({r["class"] for r in rows})
    cls_to_int = {c: i for i, c in enumerate(classes)}
    records = [
        {
            "id": r["id"],
            "path": os.path.join(cfg.data_root, r.get("dir", ""), "aclip", r.get("aclip", f"{r['id']}.wav")),
            "label": cls_to_int[r["class"]],
            "fold": 1,
        }
        for r in rows
    ]
    texts, label_ids, label_map = _prompted_label_texts(cfg, classes)
    return [([], records)], classes, label_ids, {"label_map": label_map}


def build_audioset_eval_fold(cfg, data_name: str = "audioset"):
    """Dedicated AudioSet zero-shot eval: JSONL-lines index at
    ``{data_root}/{eval_name}.csv`` with ``{id, dir, aclip|clip, labels}``,
    labels resolved through the ontology label map to MULTI-HOT vectors and
    an "<O>"-joined label string
    (parity: `reference/cvap/data/esc50.py:326-375`)."""
    from .audioset import build_audioset_label_map, label_map_token_matrix

    label_map = build_audioset_label_map(cfg)
    n_class = len(label_map)
    classes = [""] * n_class
    for lid, (idx, text, toks) in label_map.items():
        classes[idx] = text
    label_ids = label_map_token_matrix(label_map)

    eval_name = str(cfg.get("eval_name", "") or data_name)
    records = []
    for r in load_jsonl(os.path.join(cfg.data_root, f"{eval_name}.csv")):
        sub = r.get("dir", "")
        sub = "" if not sub else f"{sub}/"
        akey = "clip" if "clip" in r else "aclip"
        hot = np.zeros((n_class,), np.int32)
        names = set()
        for cat in r["labels"]:
            if cat not in label_map:  # label absent from eval_segments.csv
                continue
            idx, text, _ = label_map[cat]
            hot[idx] = 1
            names.add(text)
        records.append(
            {
                "id": r["id"],
                "path": os.path.join(
                    cfg.data_root, f"{sub}{akey}", f"{r['id']}.{r[akey][0]}"
                ),
                "label": hot,
                "label_str": "<O>".join(sorted(names)),
                "fold": 1,
            }
        )
    return [([], records)], classes, label_ids, {"label_map": None}


def build_voxceleb2_eval_fold(cfg, data_name: str = "voxceleb2"):
    """Dedicated VoxCeleb2 speaker-id eval: samples ``nsample_per_vid``
    clips per video from ``{data_name}_list.csv`` (JSONL lines mapping
    vox_id -> [[file, subdir], ...]), synthesizes aac clip paths, builds the
    test split from ``{data_name}.csv`` (JSONL lines with split/name/vox_id
    and vggface2 face fields), and returns a speaker-id -> face-file map
    (parity: `reference/cvap/data/esc50.py:377-446`)."""
    rng = np.random.default_rng(int(cfg.get("seed", 0)))
    nsample_per_vid = int(cfg.get("nsample_per_vid", 1))

    samples_by_vid: Dict[str, List[str]] = defaultdict(list)
    for rec in load_jsonl(os.path.join(cfg.data_root, f"{data_name}_list.csv")):
        (vox_id, clips), = rec.items()
        n = min(nsample_per_vid, len(clips))
        for idx in rng.choice(len(clips), n, replace=False):
            fname, sub = clips[int(idx)]
            samples_by_vid[vox_id].append(f"{sub}/{fname}")

    str2lid: Dict[str, int] = {}
    lid2str: Dict[int, str] = {}
    lid2face: Dict[int, str] = {}
    records = []
    for rec in load_jsonl(os.path.join(cfg.data_root, f"{data_name}.csv")):
        if rec["split"] != "test":  # dev rows are skipped like the reference
            continue
        name, vox_id = rec["name"], rec["vox_id"]
        lid = str2lid.setdefault(name, len(str2lid))
        lid2str.setdefault(lid, name)
        lid2face.setdefault(
            lid,
            os.path.join(
                cfg.data_root, "vggface2",
                f'{rec["vgg_split"]}/{rec["vgg_id"]}/{rec["face"]}',
            ),
        )
        for sample in samples_by_vid.get(vox_id, []):
            records.append(
                {
                    "id": f"{vox_id}/{sample}",
                    "path": os.path.join(cfg.data_root, "aac", vox_id, sample),
                    "label": lid,
                    "fold": 1,
                }
            )

    classes = [lid2str[i] for i in range(len(lid2str))]
    texts, label_ids, label_map = _prompted_label_texts(cfg, classes)
    return [([], records)], classes, label_ids, {
        "label_map": label_map,
        "faces": lid2face,
    }


def build_xfold_dataloader_list(
    cfg, data_name: Optional[str] = None, num_workers: Optional[int] = None,
    mreserve: bool = False, device_put_fn=None,
):
    """Dispatch by name → list of (train_loader, eval_loader) per fold,
    plus (classes, tokenized label prompts)
    (parity: `reference/cvap/data/esc50.py:448-458`). The training loaders
    place their batches with ``device_put_fn``; the eval loaders' batches
    stay host arrays.

    ``mreserve=True`` (or ``cfg.running.mreserve=True``) swaps the item
    path to :class:`MReserveDataset` — the reference's optional external
    MERLOT-Reserve comparison (`:194-216`); needs the optional `mreserve`
    package at iteration time."""
    run = cfg.running
    mreserve = mreserve or bool(run.get("mreserve", False))
    data_name = data_name or run.data_name
    if data_name.startswith("esc"):
        folds, classes, label_ids, extras = build_esc50_folds(run, data_name)
    elif data_name.startswith("us8k") or data_name == "UrbanSound8K":
        folds, classes, label_ids, extras = build_us8k_folds(run, data_name)
    elif data_name.startswith("audioset"):
        folds, classes, label_ids, extras = build_audioset_eval_fold(run, data_name)
    elif data_name.startswith("voxceleb"):
        folds, classes, label_ids, extras = build_voxceleb2_eval_fold(run, data_name)
    else:
        folds, classes, label_ids, extras = build_jsonl_eval_fold(run, data_name)

    loaders = []
    collate = MReserveCollator() if mreserve else AudioLabelCollator()
    dataset_cls = MReserveDataset if mreserve else AudioLabelDataset
    # the reference's mreserve eval stops at cfg.eval_samples (`:136-137`)
    # — the per-item video segmentation is expensive; the plain ESC x-fold
    # protocol evaluates full folds
    mres_limit = eval_sample_limit(run.get("eval_samples")) if mreserve else None
    for train_recs, eval_recs in folds:
        mk = lambda recs, train: (
            DataLoader(
                dataset_cls(run, recs if train else recs[:mres_limit], train),
                batch_size=int(run.batch_size),
                collate_fn=collate,
                shuffle=train,
                drop_last=train,
                num_workers=num_workers or int(cfg.get("num_proc", 4)),
                seed=int(cfg.get("seed", 0)),
                pad_last=not train,  # fixed eval shapes
                backend=str(cfg.get("loader_backend", "thread")),
                device_put_fn=device_put_fn if train else None,
            )
            if recs
            else None
        )
        loaders.append((mk(train_recs, True), mk(eval_recs, False)))
    return loaders, classes, label_ids, extras
