"""AudioSet datasets: label maps, filter sets, multi-label classification
with waveform mixup, contrastive (labels-as-text) mode, weighted sampling.

The port's own copy of ``vipant_tpu/data/audioset.py``; a ``pak*`` name
reads the packed classification dataset (:mod:`.packed`, ``clf`` only), its
filter set applied over every packed row before the eval cap and its
sampling weights from the packed multi-hot matrix. With ``running.audio.on_device`` an
item that takes no mixup ships its cropped waveform and its true length
(``audio_len``), as the VA dataset does (the JAX package's item carries no
length); a mixup rate above 0 turns ``on_device`` off, with a warning.

Parity with `reference/cvap/data/audioset_cls.py`,
`audioset_clf.py`, and `audioset_hub.py`: ontology-driven label map
restricted to eval-present labels with prompt-prefixed BPE texts
(`audioset_hub.py:76-106`), 3-format filter sets (`:32-58`), Beta(10,10)
waveform mixup with label mixing (`audioset_cls.py:374-414`), and
1000/(count+1) sampling weights (`audioset_cls.py:222-231`).
"""

from __future__ import annotations

import csv
import json
import logging
import os
import warnings
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..tokenizer import tokenize
from .image_audio import ImageAudioDatasetSrc, refuse_unported
from .indexfile import shard_for_host
from .loader import DataLoader
from .transforms_audio import extract_fbank_features
from .wav import read_wav


def build_filter_set(spec: Optional[str], data_root: Optional[str] = None) -> Optional[set]:
    """ytid filter set from a ``"name,topk"`` spec, resolved against
    ``data_root`` (parity: `reference/cvap/data/audioset_hub.py:32-58`).

    Three file formats, keyed like the reference:
      * ``*.csv``        — one sample id per line;
      * name ends ``k``  — JSON dict ``{label: [sample, ...]}``, union of values
                           (the reference's samples-per-label buckets);
      * otherwise        — JSONL, each line ``{key: [(name, score), ...]}``:
                           keep the top-``topk`` names plus the key itself.
    Returns None when the spec is empty or the file is missing (the reference
    swallows every failure into ``samples = None``)."""
    if not spec:
        return None
    name, _, topk = str(spec).partition(",")
    name = name.strip()
    path = name
    if not os.path.exists(path) and data_root:
        path = os.path.join(str(data_root), name)
    if not os.path.exists(path):
        return None
    try:
        ids: set = set()
        if path.endswith(".csv"):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        ids.add(line)
        elif path.endswith("k"):
            with open(path) as f:
                samples_per_label = json.load(f)
            for v in samples_per_label.values():
                ids.update(v)
        else:
            k = int(topk)
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    key, v = next(iter(json.loads(line).items()))
                    ids.update(str(nm) for nm, _ in v[:k])
                    ids.add(key)
        return ids
    except Exception:
        return None


def label_map_token_matrix(label_map, ctx: int = 77) -> np.ndarray:
    """[n_class, ctx] int32 token matrix from a label map's bpe rows,
    ordered by class index — the shared input of every label-prompt
    zero-shot path."""
    ids = np.zeros((len(label_map), ctx), np.int32)
    for _, (i, _, toks) in label_map.items():
        ids[i, : min(len(toks), ctx)] = toks[:ctx]
    return ids


def build_audioset_label_map(
    cfg, label_map_spec: Optional[str] = None
) -> Dict[str, Tuple[int, str, List[int]]]:
    """label id ("/m/...") → (int index, prompt text, bpe tokens), built
    from ontology.json restricted to labels present in the eval-segments CSV
    (parity: `reference/cvap/data/audioset_hub.py:76-106`)."""
    spec = label_map_spec or cfg.get("label_map", "ontology,eval_segments")
    onto_name, seg_name = [s.strip() for s in str(spec).split(",")]
    with open(os.path.join(cfg.data_root, f"{onto_name}.json")) as f:
        ontology = json.load(f)
    name_by_id = {o["id"]: o["name"] for o in ontology}

    present: List[str] = []
    seg_path = os.path.join(cfg.data_root, f"{seg_name}.csv")
    with open(seg_path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.rstrip("\n").split(",", 3)
            if len(parts) < 4:
                continue
            labels = parts[3].strip().strip('"').split(",")
            present.extend(l.strip() for l in labels)
    # class indices follow ONTOLOGY order, not lexicographic order — the
    # reference builds category_list in ontology order then filters it
    # (`audioset_hub.py:84-103`), so index assignments must match.
    present_set = set(l for l in present if l in name_by_id)
    keep = [o["id"] for o in ontology if o["id"] in present_set]

    prompt = str(cfg.get("prompt", "") or "")
    label_map: Dict[str, Tuple[int, str, List[int]]] = {}
    for i, lid in enumerate(keep):
        # ontology names like "Dog" → "the sound of dog"
        text = f"{prompt} {name_by_id[lid].lower()}".strip()
        label_map[lid] = (i, text, tokenize(text, as_list=True)[0])
    return label_map


def print_label_dist(echo, label_counts, lid2label, ncol: int = 18) -> str:
    """Per-category instance-count table logged when weighted sampling is
    on (parity: `reference/cvap/data/audioset_cls.py:39-58`, minus
    the tabulate/termcolor deps): names truncated to 15 chars, ``ncol``
    alternating category/# columns, pipe format."""
    short = lambda x: x[:13] + ".." if len(x) > 15 else x
    cells: List[str] = []
    for i, v in enumerate(label_counts):
        cells += [short(str(lid2label.get(i, i))), str(int(v))]
    total = int(sum(label_counts))
    cells += [""] * ((-len(cells)) % ncol)
    rows = [cells[r : r + ncol] for r in range(0, len(cells), ncol)]
    widths = [max(len(r[c]) for r in rows) for c in range(ncol)]
    header = ["category", "#"] * (ncol // 2)
    widths = [max(w, len(h)) for w, h in zip(widths, header)]
    fmt = lambda row: "| " + " | ".join(c.ljust(w) for c, w in zip(row, widths)) + " |"
    sep = "|" + "|".join("-" * (w + 2) for w in widths) + "|"
    table = "\n".join([fmt(header), sep] + [fmt(r) for r in rows])
    msg = (
        f"Distribution of instances among all {len(label_counts)} categories "
        f"(total {total}):\n{table}"
    )
    echo(msg)
    return msg


def label_counts(records: List[Dict], label_map: Dict, nlabel: int) -> np.ndarray:
    counts = np.zeros(nlabel, np.float64)
    for rec in records:
        for lid in rec.get("labels", []):
            if lid in label_map:
                counts[label_map[lid][0]] += 1
    return counts


def sampling_weights(records: List[Dict], label_map: Dict, nlabel: int) -> np.ndarray:
    """1000/(count+1) weights summed per record's labels
    (parity: `reference/cvap/data/audioset_cls.py:222-231`)."""
    counts = label_counts(records, label_map, nlabel)
    per_label = 1000.0 / (counts + 1.0)
    weights = np.zeros(len(records), np.float64)
    for i, rec in enumerate(records):
        weights[i] = sum(
            per_label[label_map[lid][0]] for lid in rec.get("labels", []) if lid in label_map
        )
    return np.maximum(weights, 1e-8)


class AudiosetSrc(ImageAudioDatasetSrc):
    """AudioSet records ``{"id","dir","aclip","frame","labels":[lids]}``.

    clf mode: binary label vector + optional waveform mixup.
    contrastive mode: VA item + label-text tokens
    (parity: `reference/cvap/data/audioset_cls.py:193-465`).
    """

    def __init__(
        self,
        cfg,
        data_name: str,
        train: bool,
        label_map: Dict,
        clf: bool = True,
        mixup_rate: float = 0.0,
        filter_set: Optional[set] = None,
        external_text: Optional[Dict] = None,
    ):
        super().__init__(cfg, data_name, train)
        if filter_set:
            self.records = [r for r in self.records if r["id"] in filter_set]
        # external captions replacing label prompts: id -> list of caption
        # strings (tokenized on the fly) or caption ids (precomputed text
        # embeddings under {data_root}/caption/{text_emb}/{cid}.npz)
        # (parity: `reference/cvap/data/audioset_cls.py:253-256,291-297`).
        # Records without captions are dropped (the reference substitutes a
        # '-1' sentinel path that would fail at load time anyway).
        self.external_text = external_text
        self.text_emb = cfg.get("text_emb", None)
        if external_text is not None and not clf:
            # non-empty check too: an id mapped to [] must drop like a
            # missing one, not IndexError inside a loader thread
            self.records = [r for r in self.records if external_text.get(r["id"])]
        nper = int(cfg.get("nper_label", -1) or -1)
        if nper > 0:  # cap records per label
            by_label = defaultdict(int)
            kept = []
            for r in self.records:
                lids = [l for l in r.get("labels", []) if l in label_map]
                if any(by_label[l] < nper for l in lids):
                    kept.append(r)
                    for l in lids:
                        by_label[l] += 1
            self.records = kept
        self.label_map = label_map
        self.nlabel = len(label_map)
        self.clf = clf
        self.mixup_rate = mixup_rate
        if clf and mixup_rate > 0 and self.on_device:
            # waveform mixup computes fbank on the host; items taking the
            # mixup branch would be [T, M] while the rest ship waveforms —
            # ragged batches. Keep every item on the host fbank path.
            warnings.warn(
                "mixup_rate > 0: disabling on-device featurization for this "
                "dataset (mixup items are host-featurized)"
            )
            self.on_device = False

    def _label_vector(self, rec: Dict) -> np.ndarray:
        vec = np.zeros(self.nlabel, np.float32)
        for lid in rec.get("labels", []):
            if lid in self.label_map:
                vec[self.label_map[lid][0]] = 1.0
        return vec

    def _label_text(self, rec: Dict) -> np.ndarray:
        """Concatenate (or pick) label prompts as one 77-token sequence."""
        lids = [l for l in rec.get("labels", []) if l in self.label_map]
        if not lids:
            toks = [49406, 49407]
        elif bool(self.cfg.get("cat_label", False)):
            texts = [self.label_map[l][1] for l in lids]
            toks = tokenize(", ".join(texts), as_list=True)[0]
        else:
            pick = np.random.choice(len(lids)) if self.train else 0
            toks = self.label_map[lids[pick]][2]
        out = np.zeros(77, np.int32)
        toks = toks[:77]
        out[: len(toks)] = toks
        return out

    def _audio_clf(self, index: int) -> Tuple[Dict, np.ndarray]:
        """(:meth:`_audio_item`, labels): the fbank with optional waveform
        mixup + mixed labels
        (parity: `reference/cvap/data/audioset_cls.py:374-414`)."""
        rec = self.records[index]
        _, aclip_file, _, _ = self._paths(index)
        label = self._label_vector(rec)
        if self.train and self.mixup_rate > 0 and np.random.rand() < self.mixup_rate:
            j = int(np.random.randint(len(self.records)))
            _, other_file, _, _ = self._paths(j)
            try:
                w1, sr = read_wav(aclip_file)
                w2, _ = read_wav(other_file)
                # reference semantics (`reference/cvap/data/audioset_cls.py:374-400`):
                # zero-mean each waveform, fit the partner to the first clip's
                # length (truncate or zero-pad), λ-mix, re-zero-mean, and mix
                # the labels SOFT: lam*y1 + (1-lam)*y2.
                w1 = w1 - w1.mean()
                w2 = w2 - w2.mean()
                n = w1.shape[-1]
                if w2.shape[-1] >= n:
                    w2 = w2[..., :n]
                else:
                    w2 = np.pad(w2, [(0, 0)] * (w2.ndim - 1) + [(0, n - w2.shape[-1])])
                lam = float(np.random.beta(10.0, 10.0))
                mixed = lam * w1 + (1 - lam) * w2
                mixed = mixed - mixed.mean()
                audio = extract_fbank_features(
                    (mixed, sr),
                    self.params,
                    max_audio_len=int(self.cfg.max_audio_len),
                    train=self.train,
                    zero_mean_wf=bool(self.acfg.get("zero_mean_wf", True)),
                    norms=self.norms,
                    transform_fbank=self.transform_fbank,
                )
                label = lam * label + (1 - lam) * self._label_vector(self.records[j])
                return {"audio": audio}, label
            except Exception:
                pass
        return self._audio_item(aclip_file), label

    def _audio_item(self, fname: str) -> Dict:
        """``{"audio": fbank}``, or with ``on_device`` ``{"audio": the
        cropped waveform, "audio_len": its true length}``."""
        if self.on_device:
            wav, n = self._audio_waveform(fname)
            return {"audio": wav, "audio_len": n}
        return {"audio": self._audio(fname)}

    def __getitem__(self, index: int) -> Dict:
        rec = self.records[index]
        name, aclip_file, frame_file, frame_emb_file = self._paths(index)
        image = (
            self._image_emb(frame_emb_file)
            if frame_emb_file is not None
            else self._image(frame_file)
        )
        if self.clf:
            audio, label = self._audio_clf(index)
            return {"image": image, **audio, "label": label, "name": name}
        audio = self._audio_item(aclip_file)
        lids = [l for l in rec.get("labels", []) if l in self.label_map]
        pick = int(np.random.choice(len(lids))) if (self.train and lids) else 0
        label = self.label_map[lids[pick]][0] if lids else -1
        return {
            "image": image,
            **audio,
            "text": self._external_or_label_text(rec),
            "label": label,
            "name": name,
        }

    def _external_or_label_text(self, rec: Dict) -> np.ndarray:
        if self.external_text is None:
            return self._label_text(rec)
        caps = self.external_text[rec["id"]]
        pick = int(np.random.choice(len(caps))) if self.train else 0
        cap = caps[pick]
        if isinstance(cap, str):  # raw caption text -> tokens
            toks = tokenize(cap, as_list=True)[0][:77]
            out = np.zeros(77, np.int32)
            out[: len(toks)] = toks
            return out
        # caption id -> precomputed text embedding
        path = os.path.join(
            str(self.cfg.data_root), "caption", str(self.text_emb), f"{cap}.npz"
        )
        return np.load(path)["v"].astype(np.float32).reshape(-1)


class AudiosetCollator:
    def __init__(self, clf: bool):
        self.clf = clf

    def __call__(self, items: List[Dict]) -> Dict[str, np.ndarray]:
        image = np.stack([it["image"] for it in items])
        if image.dtype != np.uint8:  # uint8 images normalize on device
            image = image.astype(np.float32)
        audio = np.stack([it["audio"] for it in items]).astype(np.float32, copy=False)
        if audio.ndim == 3:  # fbank [B, T, M] → [B, 1, T, M]; waveforms stay 2-D
            audio = audio[:, None]
        out = {
            "image": image,
            "audio": audio,
            "name": [it["name"] for it in items],
        }
        if "audio_len" in items[0]:  # waveforms: each clip's true length
            out["audio_len"] = np.asarray([it["audio_len"] for it in items], np.int64)
        if self.clf:
            out["label"] = np.stack([it["label"] for it in items]).astype(np.float32, copy=False)
        else:
            text = np.stack([it["text"] for it in items])
            # integer rows are BPE tokens; float rows are precomputed
            # text embeddings (passed through the model by dtype/rank)
            out["text"] = text.astype(
                np.int32 if np.issubdtype(text.dtype, np.integer) else np.float32
            )
            out["label"] = np.asarray([it.get("label", -1) for it in items], np.int32)
        return out


def build_audioset_dataloader(
    cfg,
    data_name: str,
    train: bool,
    label_map: Optional[Dict] = None,
    process_id: int = 0,
    num_processes: int = 1,
    device_put_fn=None,
):
    """(parity: `reference/cvap/data/audioset_hub.py:108-143` +
    `reference/cvap/data/audioset_clf.py:154-194` weighted path)."""
    run = cfg.running
    label_map = label_map or build_audioset_label_map(run)
    filter_set = build_filter_set(run.get("filter_set"), run.get("data_root"))
    clf = bool(run.get("clf", True))
    refuse_unported(run)
    if data_name.startswith("pak"):
        # packed clf shards (data/packed.py): one-gather batch fast path.
        # Contrastive (clf=False) recipes need per-item label-text/caption
        # picks — not packed; the trimodal path stays on npz/src.
        if not clf:
            raise ValueError("packed AudioSet shards support clf=True only")
        from .packed import AudiosetDatasetPak

        ds = AudiosetDatasetPak(run, data_name, train, label_map)
        if filter_set:
            # the ytid filter the src path applies in AudiosetSrc.__init__,
            # over ALL packed rows, then the eval cap again: the src path
            # filters at init and caps at iteration, so capping first would
            # evaluate a smaller, different subset
            kept = [r for r in range(ds.meta["n"]) if ds.names[r] in filter_set]
            ds.records = kept[: ds.eval_limit]
        ds.records = shard_for_host(ds.records, process_id, num_processes, train)
        weights = None
        if train and bool(run.get("weighted_sampling", False)):
            # the 1000/(count+1) per-label weights of sampling_weights,
            # from the packed multi-hot matrix
            lab = np.asarray(ds.label[ds.records], np.float64)
            per_label = 1000.0 / (lab.sum(0) + 1.0)
            weights = np.maximum(lab @ per_label, 1e-8)
        return DataLoader(
            ds,
            batch_size=int(run.batch_size) // max(num_processes, 1),
            collate_fn=AudiosetCollator(clf),
            shuffle=train and weights is None,
            drop_last=train,
            num_workers=int(cfg.get("num_proc", 4)),
            backend=str(cfg.get("loader_backend", "thread")),
            seed=int(cfg.get("seed", 0)),
            device_put_fn=device_put_fn,
            sample_weights=weights,
            pad_last=not train,
        )
    external_text = None
    if run.get("text_emb"):  # {data_root}/caption/{text_emb}.csv: id -> captions
        text_file = os.path.join(str(run.data_root), "caption", f"{run.text_emb}.csv")
        with open(text_file) as f:
            external_text = json.load(f)
    ds = AudiosetSrc(
        run,
        data_name,
        train,
        label_map,
        clf=clf,
        mixup_rate=float(run.get("mixup_rate", 0.0)) if train else 0.0,
        filter_set=filter_set,
        external_text=external_text,
    )
    ds.records = shard_for_host(ds.records, process_id, num_processes, train)
    weights = None
    if train and bool(run.get("weighted_sampling", False)):
        weights = sampling_weights(ds.records, label_map, len(label_map))
        # the reference prints the label distribution whenever it computes
        # the weights (`reference/cvap/data/audioset_clf.py:51`)
        import re as _re

        prompt = str(run.get("prompt", "") or "")
        lid2label = {
            v[0]: _re.sub(f"^{_re.escape(prompt)}", "", v[1]).strip()
            for v in label_map.values()
        }
        print_label_dist(
            logging.getLogger("vipant").info,
            label_counts(ds.records, label_map, len(label_map)),
            lid2label,
        )
    return DataLoader(
        ds,
        batch_size=int(run.batch_size) // max(num_processes, 1),
        collate_fn=AudiosetCollator(clf),
        shuffle=train and weights is None,
        drop_last=train,
        num_workers=int(cfg.get("num_proc", 4)),
        backend=str(cfg.get("loader_backend", "thread")),
        seed=int(cfg.get("seed", 0)),
        device_put_fn=device_put_fn,
        sample_weights=weights,
        pad_last=not train,  # fixed eval shapes
    )
