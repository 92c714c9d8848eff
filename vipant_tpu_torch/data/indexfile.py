"""Index-file handling: every dataset is a JSONL/CSV index of records
``{id, dir, aclip, frame, labels/captions}`` with media at
``{data_root}/{dir}/{aclip|frame_key}/{id}.{ext}``
(convention: `reference/cvap/data/image_audio.py:131-151`).

Host sharding: each process takes a strided slice of the index — the SPMD
analogue of ``DistributedSampler``
(`reference/cvap/data/image_audio.py:354-360`).

The port's own copy of ``vipant_tpu/data/indexfile.py``, with two faults of
the original fixed: :func:`eval_sample_limit` raises on a value that is not
a number (the original read a typo such as ``'25O'`` as "evaluate
everything"), and :func:`shard_for_host` wrap-pads training shards only (the
original also padded eval shards, whose duplicates shift eval numbers).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np


def load_jsonl(path: str, fraction: float = 1.0, limit: Optional[int] = None) -> List[Dict]:
    records: List[Dict] = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    if fraction < 1.0:
        records = records[: int(len(records) * fraction)]
    if limit is not None and limit > 0:
        records = records[:limit]
    return records


def load_csv(path: str, delimiter: str = ",") -> List[Dict]:
    with open(path, "r", newline="") as f:
        return list(csv.DictReader(f, delimiter=delimiter))


def resolve_media_path(
    data_root: str, record: Dict[str, Any], kind: str, ext: Optional[str] = None
) -> str:
    """kind: "aclip" (audio) or a frame key; the record stores the relative
    file name in that field."""
    name = record.get(kind) or f"{record['id']}.{ext or 'wav'}"
    return os.path.join(data_root, str(record.get("dir", "")), kind, name)


def shard_for_host(records: List, process_id: int, num_processes: int, train: bool) -> List:
    """This process's strided share of ``records``.

    Training shards have equal lengths (DistributedSampler-style wrap
    padding, `reference/cvap/data/image_audio.py:354-360`): a ragged split
    would give hosts different batch counts — one host exits the epoch loop
    while another blocks inside a collective step — and per-host
    ``steps_per_epoch`` (warmup milestones, mid-epoch resume divmod) would
    disagree. Eval shards are not padded: every record is evaluated exactly
    once across the hosts, and no wrapped duplicate shifts the numbers."""
    if num_processes <= 1:
        return records
    if not records:
        return []
    if not train:
        return records[process_id::num_processes]
    need = -(-len(records) // num_processes) * num_processes  # ceil * n
    padded = list(records)
    while len(padded) < need:  # loop: N may be < num_processes
        padded.extend(records[: need - len(padded)])
    return padded[process_id::num_processes]


def eval_sample_limit(value) -> Optional[int]:
    """``running.eval_samples`` → record cap. unset/0/negative/inf mean
    "evaluate everything" (Trainer._samples_cap blesses inf), so they map
    to None instead of crashing ``int(float('inf'))``. A value that is not a
    number raises ``ValueError``: a typo must not turn into "evaluate
    everything"."""
    if value is None:
        return None
    try:
        f = float(value)
    except (TypeError, ValueError):
        raise ValueError(f"running.eval_samples must be a number, not {value!r}") from None
    if not np.isfinite(f) or f <= 0:
        return None
    return int(f)


def epoch_permutation(n: int, epoch: int, seed: int) -> np.ndarray:
    """Deterministic per-epoch shuffle (the ``sampler.set_epoch`` analogue,
    `reference/cvap/monitor/cvap.py:106-111`)."""
    rng = np.random.default_rng(seed + epoch)
    return rng.permutation(n)
