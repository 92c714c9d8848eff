"""Image-text dataset (AudioCaps frames and captions) for CLVP, its collator
and its loader.

The port's own copy of ``vipant_tpu/data/image_text.py`` (parity:
`reference/cvap/data/image_text.py`): JSONL records ``{"id", "dir",
"frame", "captions" | "caption"}``, the frame at
``{data_root}/{dir}/frame/{id}.{frame}`` (the middle one of a list),
CLIP-preprocessed to fp32 (a missing or corrupt frame becomes a random
image); a random caption per item at train, every caption of an item at
eval (short lists padded cyclically to the longest), as
:mod:`.audio_text` does. The eval loader does not pad its last batch, as
the JAX package's does not.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..tokenizer import tokenize
from .indexfile import load_jsonl, shard_for_host
from .loader import DataLoader
from .transforms_image import clip_preprocess


class ImageTextDatasetSrc:
    def __init__(self, cfg, records: List[Dict], train: bool, ctx_len: int = 77):
        self.cfg = cfg
        self.records = records
        self.train = train
        self.ctx_len = ctx_len
        # uniform caption count at eval: the 1-vs-k grouping assumes exactly
        # k captions per clip; short lists are padded cyclically (same
        # convention as AudioTextDatasetSrc)
        self.eval_k = max((len(r["captions_bpe"]) for r in records), default=1)

    def __len__(self) -> int:
        return len(self.records)

    def _pad(self, toks):
        out = np.zeros((self.ctx_len,), np.int32)
        toks = toks[: self.ctx_len]
        out[: len(toks)] = toks
        return out

    def __getitem__(self, index: int) -> Dict:
        from PIL import Image as PILImage

        rec = self.records[index]
        sub = rec.get("dir", "")
        frame = rec.get("frame")
        frame = frame if isinstance(frame, str) else frame[len(frame) // 2]
        path = os.path.join(self.cfg.data_root, sub, "frame", f"{rec['id']}.{frame}")
        try:
            image = clip_preprocess(PILImage.open(path), int(self.cfg.get("resolution", 224)))
        except Exception:
            res = int(self.cfg.get("resolution", 224))
            image = clip_preprocess(
                PILImage.fromarray((np.random.rand(res, res, 3) * 256).astype(np.uint8)), res
            )
        caps = rec["captions_bpe"]
        if self.train:
            text = self._pad(caps[int(np.random.choice(len(caps)))])
        else:
            caps = [caps[i % len(caps)] for i in range(self.eval_k)]
            text = np.stack([self._pad(c) for c in caps])
        return {"image": image, "text": text, "name": rec["id"]}


class ImageTextCollator:
    def __init__(self, train: bool):
        self.train = train

    def __call__(self, items: List[Dict]) -> Dict[str, np.ndarray]:
        text = (
            np.stack([it["text"] for it in items])
            if self.train
            else np.concatenate([it["text"] for it in items], axis=0)
        )
        return {
            "image": np.stack([it["image"] for it in items]).astype(np.float32, copy=False),
            "text": text.astype(np.int32),
            "name": [it["name"] for it in items],
        }


def build_image_text_dataloader(
    cfg, data_name: str, train: bool, process_id: int = 0, num_processes: int = 1,
    device_put_fn=None,
):
    """``{data_root}/{data_name}.jsonl`` -> records with the prompt-prefixed
    BPE captions -> the host-sharded loader."""
    run = cfg.running
    rows = load_jsonl(os.path.join(run.data_root, f"{data_name}.jsonl"))
    prompt = str(run.get("prompt", "") or "")
    records = []
    for row in rows:
        caps = row.get("captions") or [row["caption"]]
        captions = [f"{prompt} {c}".strip() for c in caps]
        records.append(
            {
                "id": row["id"],
                "dir": row.get("dir", data_name),
                "frame": row.get("frame", "0.jpg"),
                "captions_bpe": tokenize(captions, as_list=True),
            }
        )
    records = shard_for_host(records, process_id, num_processes, train)
    ctx = int(cfg.model.text.get("ctx_len", 77)) if "text" in cfg.model else 77
    ds = ImageTextDatasetSrc(run, records, train, ctx_len=ctx)
    return DataLoader(
        ds,
        batch_size=int(run.batch_size) // max(num_processes, 1),
        collate_fn=ImageTextCollator(train),
        shuffle=train,
        drop_last=train,
        num_workers=int(cfg.get("num_proc", 4)),
        backend=str(cfg.get("loader_backend", "thread")),
        seed=int(cfg.get("seed", 0)),
        device_put_fn=device_put_fn,
    )
