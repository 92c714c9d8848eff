"""Audio-text (AT) fine-tuning and retrieval datasets, their collator and
their loader.

The port's own copy of ``vipant_tpu/data/audio_text.py`` for the raw wav
datasets: the Clotho CSV and AudioCaps JSONL readers, with the prompt
prefix and BPE tokenisation at list-build time, a random caption per clip at
train and all of a clip's captions at eval, and dispatch on the dataset
name's prefix (parity: `reference/cvap/data/audio_text.py`,
`reference/cvap/data/audiocaps.py`). Captions are padded to the fixed
77-token context when an item is made, where the reference padded each batch
to its longest caption (`:105-137`): every batch then has one shape. A
``pak*`` name reads the packed AT dataset (:mod:`.packed`), whose batches
come from one gather each.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, List

import numpy as np

from ..tokenizer import tokenize
from .image_audio import fbank_params_from_cfg, refuse_unported
from .indexfile import eval_sample_limit, load_csv, load_jsonl, shard_for_host
from .loader import DataLoader
from .transforms_audio import extract_fbank_features, make_transform


def build_clotho_list(cfg, data_name: str, prompt: str = "") -> List[Dict]:
    """Clotho CSV: columns file_name, caption_1..caption_5
    (parity: `reference/cvap/data/audio_text.py:169-200`)."""
    rows = load_csv(os.path.join(cfg.data_root, f"{data_name}.csv"))
    records = []
    for row in rows:
        captions = [
            f"{prompt} {row[f'caption_{i}']}".strip() for i in range(1, 6) if row.get(f"caption_{i}")
        ]
        records.append({
            "id": row["file_name"].rsplit(".", 1)[0],
            "dir": data_name,
            "aclip": row["file_name"],
            "captions": captions,
            "captions_bpe": tokenize(captions, as_list=True),
        })
    return _drop_captionless(records, data_name)


def _drop_captionless(records: List[Dict], data_name: str) -> List[Dict]:
    """Drop, with a warning, each record whose caption cells are all empty:
    it would fail inside a worker mid-epoch (``np.random.choice(0)`` at
    train, a modulo by zero at eval)."""
    bad = [r["id"] for r in records if not r["captions_bpe"]]
    if bad:
        warnings.warn(f"{data_name}: dropping {len(bad)} record(s) without any caption "
                      f"(e.g. {bad[:3]})")
        records = [r for r in records if r["captions_bpe"]]
    return records


def build_audiocaps_list(cfg, data_name: str, prompt: str = "") -> List[Dict]:
    """AudioCaps JSONL: records with ``id`` and ``captions`` (or one
    ``caption``) (parity: `reference/cvap/data/audio_text.py:202-215`)."""
    rows = load_jsonl(os.path.join(cfg.data_root, f"{data_name}.jsonl"))
    records = []
    for row in rows:
        # an explicitly empty captions list stays empty and is dropped below
        caps = row["captions"] if "captions" in row else [row["caption"]]
        captions = [f"{prompt} {c}".strip() for c in caps]
        records.append({
            "id": row["id"],
            "dir": row.get("dir", data_name),
            "aclip": row.get("aclip", f"{row['id']}.wav"),
            "captions": captions,
            "captions_bpe": tokenize(captions, as_list=True),
        })
    return _drop_captionless(records, data_name)


class AudioTextDatasetSrc:
    """Raw wav + captions (parity: `reference/cvap/data/audio_text.py:23-103`):
    a random caption at train; at eval all k captions, a clip with fewer
    padded cyclically to the most any clip has (``eval_k``), since the 1-vs-k
    report groups exactly k captions per clip."""

    def __init__(self, cfg, records: List[Dict], train: bool, ctx_len: int = 77):
        self.cfg = cfg
        self.records = records
        self.train = train
        self.ctx_len = ctx_len
        self.eval_k = max((len(r["captions_bpe"]) for r in records), default=1)
        acfg = cfg.audio
        self.acfg = acfg
        self.params = fbank_params_from_cfg(acfg)
        self.norms = tuple(acfg.get("norms", []) or []) or None
        self.transform_audio, self.transform_fbank = make_transform(acfg)

    def __len__(self) -> int:
        return len(self.records)

    def _pad(self, toks: List[int]) -> np.ndarray:
        out = np.zeros((self.ctx_len,), np.int32)
        if len(toks) > self.ctx_len:
            # truncate but keep the final EOT: the text tower pools at
            # argmax(ids), the EOT being the largest id (as CLIP's truncate)
            toks = toks[: self.ctx_len - 1] + [toks[-1]]
        out[: len(toks)] = toks
        return out

    def __getitem__(self, index: int) -> Dict[str, Any]:
        rec = self.records[index]
        sub = rec.get("dir", "")
        path = os.path.join(self.cfg.data_root, sub, "aclip", rec["aclip"])
        if not os.path.exists(path):
            path = os.path.join(self.cfg.data_root, sub, rec["aclip"])
        audio = extract_fbank_features(
            path,
            self.params,
            max_audio_len=int(self.cfg.max_audio_len),
            train=self.train,
            zero_mean_wf=bool(self.acfg.get("zero_mean_wf", True)),
            tile_audio=bool(self.acfg.get("tile_audio", False)),
            transform_audio=self.transform_audio if self.train else None,
            norms=self.norms,
            transform_fbank=self.transform_fbank if self.train else None,
        )
        caps = rec["captions_bpe"]
        if self.train:
            text = self._pad(caps[int(np.random.choice(len(caps)))])
            return {"audio": audio, "text": text, "name": rec["id"]}
        caps = [caps[i % len(caps)] for i in range(self.eval_k)]
        text = np.stack([self._pad(c) for c in caps])  # [k, ctx]
        return {"audio": audio, "text": text, "name": rec["id"]}


class AudioTextCollator:
    """Train: text [B, ctx]; eval: each clip's k captions flattened to
    [B * k, ctx] (parity: `reference/cvap/data/audio_text.py:105-137`)."""

    def __init__(self, train: bool):
        self.train = train

    def __call__(self, items: List[Dict]) -> Dict[str, Any]:
        audio = np.stack([it["audio"] for it in items]).astype(np.float32, copy=False)[:, None]
        if self.train:
            text = np.stack([it["text"] for it in items])
        else:
            text = np.concatenate([it["text"] for it in items], axis=0)
        return {"audio": audio, "text": text.astype(np.int32), "name": [it["name"] for it in items]}


def build_audio_text_dataloader(
    cfg, data_name: str, train: bool, process_id: int = 0, num_processes: int = 1,
    device_put_fn=None,
):
    """Dispatch on the name's prefix: ``pak`` (the packed AT dataset),
    Clotho or AudioCaps
    (parity: `reference/cvap/data/audio_text.py:233-245`). The batches are
    host arrays unless ``device_put_fn`` places them
    (:class:`vipant_tpu_torch.data.device_put.PinnedDevicePut`)."""
    run = cfg.running
    refuse_unported(run)
    ctx = int(cfg.model.text.get("ctx_len", 77)) if "text" in cfg.model else 77
    if data_name.startswith("pak"):
        # packed shards (data/packed.py): one-gather batch fast path
        from .packed import AudioTextDatasetPak

        ds = AudioTextDatasetPak(run, data_name, train)
        assert ds.text.shape[-1] == ctx, (
            f"pack ctx_len {ds.text.shape[-1]} != model.text.ctx_len {ctx} — repack"
        )
        ds.records = shard_for_host(ds.records, process_id, num_processes, train)
    else:
        prompt = str(run.get("prompt", "") or "")
        if data_name.startswith("clotho"):
            records = build_clotho_list(run, data_name, prompt)
        else:
            records = build_audiocaps_list(run, data_name, prompt)
        if bool(run.get("np_rnd", False)):
            # the random-caption baseline: captions permuted across clips
            # (parity: `reference/cvap/data/audiocaps.py:64,105-110`)
            perm = np.random.permutation(len(records))
            caps = [(records[i]["captions"], records[i]["captions_bpe"]) for i in perm]
            for rec, (c, cb) in zip(records, caps):
                rec["captions"], rec["captions_bpe"] = c, cb
        if not train:
            records = records[: eval_sample_limit(run.get("eval_samples"))]
        records = shard_for_host(records, process_id, num_processes, train)
        ds = AudioTextDatasetSrc(run, records, train, ctx_len=ctx)
    return DataLoader(
        ds,
        batch_size=int(run.batch_size) // max(num_processes, 1),
        collate_fn=AudioTextCollator(train),
        shuffle=train,
        drop_last=train,
        num_workers=int(cfg.get("num_proc", 4)),
        backend=str(cfg.get("loader_backend", "thread")),
        seed=int(cfg.get("seed", 0)),
        device_put_fn=device_put_fn,
        pad_last=not train,  # fixed eval shapes
    )
