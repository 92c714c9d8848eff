"""Prefetching data loader with thread or process workers.

The port's own copy of ``vipant_tpu/data/loader.py``. :func:`_worker_init`
hides the GPUs instead of pinning JAX to the CPU, and :func:`_worker_getitem`
seeds Python's ``random`` beside NumPy's with the item's seed (the siamese
image views draw from ``random``; the JAX loader seeds NumPy only, so its
views do not replay after a resume). ``sample_weights`` draws
each epoch's order with replacement from ``default_rng(seed + epoch)`` (the
AudioSet recipe's weighted sampling), the JAX loader's indices.

The reference fed the GPU from ``torch.utils.data.DataLoader`` worker
*processes* (`reference/cvap/data/image_audio.py:366-374`). Here the
decode+fbank item path runs in a pluggable pool:

- ``backend="thread"`` (default): a ``ThreadPoolExecutor`` — cheap, fine
  when items are NumPy released-GIL work or the host has one core.
- ``backend="process"``: a persistent spawn-context
  ``ProcessPoolExecutor`` — the jpg-decode + fbank item path is largely
  GIL-bound pure Python/NumPy, so thread workers cannot scale past ~1
  core; process workers scale with cores like the reference's
  ``num_proc`` DataLoader workers. A worker that dies breaks the pool, and
  the next batch raises ``BrokenProcessPool`` in the consumer.

Item futures are submitted up to ``prefetch+1`` batches ahead (not one
batch at a time), batches are assembled by a collator, and a bounded queue
keeps ``prefetch`` batches ready so the device never waits on the host
while the host keeps up. ``device_put_fn`` runs in a transfer thread of its
own, so the host-to-device copy overlaps decoding and the previous step
(:class:`vipant_tpu_torch.data.device_put.PinnedDevicePut`).
"""

from __future__ import annotations

import itertools
import os
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np

from ..utils.trace import span
from .indexfile import epoch_permutation

# ---------------------------------------------------------------- workers
# Spawned worker processes receive the dataset once (pickled via the pool
# initializer) and serve items by index — only indices and item dicts cross
# the pipe afterwards.
_WORKER_DATASET = None


def _worker_init(dataset, seed_base: int):
    global _WORKER_DATASET
    # ProcessPoolExecutor spawns workers lazily at first submit(), so env
    # set around pool CONSTRUCTION never reaches the child. Workers decode
    # and featurise on the CPU only: hide the GPUs before anything here can
    # initialise CUDA, so that a CUDA call in a worker raises instead of
    # taking a context on the card the trainer uses.
    import sys

    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError("CUDA was initialised in a data-loader worker before its set-up")
    _WORKER_DATASET = dataset
    np.random.seed(seed_base % (2 ** 31))  # fallback for unseeded tasks


def _worker_getitem(idx, seed=None):
    # per-ITEM seeding: item→worker assignment is nondeterministic in a
    # shared pool, so reproducibility cannot come from per-worker streams —
    # the parent derives one seed per item occurrence (loader seed, epoch,
    # position), making process-backend augmentations reproducible across
    # runs (the thread backend's shared stream never was)
    if seed is not None:
        np.random.seed(seed)
        random.seed(seed)
    return _WORKER_DATASET[int(idx)]


def _worker_getbatch(idxs, seed=None):
    return _WORKER_DATASET.get_batch(idxs, seed)


class DataLoader:
    def __init__(
        self,
        dataset,  # indexable: __len__, __getitem__
        batch_size: int,
        collate_fn: Callable[[List[Any]], Any],
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        device_put_fn: Optional[Callable[[Any], Any]] = None,
        pad_last: bool = False,
        backend: str = "thread",
        sample_weights: Optional[np.ndarray] = None,
    ):
        # raise glibc's malloc thresholds so the multi-MB batch buffers a
        # TRAINING loader churns through recycle warm (see hostmem.py). The
        # tuning is process-global, so eval-only loaders skip it — a tiny
        # eval loader must not raise retained RSS for the whole process.
        # VIPANT_TUNE_MALLOC=1/0 overrides in either direction.
        tune_env = os.environ.get("VIPANT_TUNE_MALLOC")
        # a training loader shuffles or samples by weight
        is_training = shuffle or sample_weights is not None
        if tune_env == "1" or (is_training and tune_env != "0"):
            from ..utils.hostmem import tune_host_allocator

            tune_host_allocator()
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.prefetch = max(prefetch, 1)
        self.seed = seed
        self.device_put_fn = device_put_fn
        self.sample_weights = sample_weights
        # pad the final partial batch (repeating its last item) so every
        # batch has a fixed shape — one jit compile instead of one per
        # remainder size; dict batches carry the true count under "_count"
        self.pad_last = pad_last
        assert backend in ("thread", "process"), backend
        self.backend = backend
        self.epoch = 0
        self._start_batch = 0
        self._proc_pool = None

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """``start_batch``: skip the first N batches of the NEXT iteration
        only — mid-epoch resume fast-forwards the deterministic epoch order
        without decoding the skipped items."""
        self.epoch = epoch
        self._start_batch = int(start_batch)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.sample_weights is not None:
            # with replacement, the WeightedRandomSampler analogue
            # (`reference/cvap/data/audioset_clf.py:154-194`)
            rng = np.random.default_rng(self.seed + self.epoch)
            return rng.choice(n, size=n, replace=True, p=self.sample_weights / self.sample_weights.sum())
        if self.shuffle:
            return epoch_permutation(n, self.epoch, self.seed)
        return np.arange(n)

    # ------------------------------------------------------------- pools
    def _get_pool(self):
        """Thread pools are cheap and made per epoch; process pools cost
        worker spawns (a fresh interpreter + imports each), so one pool
        persists for the loader's lifetime."""
        if self.backend == "thread":
            return ThreadPoolExecutor(max_workers=self.num_workers), True
        if self._proc_pool is None:
            from concurrent.futures import ProcessPoolExecutor
            import multiprocessing as mp

            # spawn (not fork): the parent holds a CUDA context plus live
            # threads — forking that is unsafe. The child hides the GPUs in
            # _worker_init (workers spawn lazily at submit time, so
            # construction-time env vars would not reach them).
            self._proc_pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=mp.get_context("spawn"),
                initializer=_worker_init,
                initargs=(self.dataset, int(self.seed)),
            )
        return self._proc_pool, False

    def shutdown(self) -> None:
        if self._proc_pool is not None:
            self._proc_pool.shutdown(wait=False, cancel_futures=True)
            self._proc_pool = None

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass

    def __iter__(self) -> Iterator[Any]:
        order = self._order()
        nb = len(self)
        batches = [
            order[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(nb)
        ]
        skipped = self._start_batch
        if skipped:  # mid-epoch resume (one-shot)
            batches = batches[skipped:]
            self._start_batch = 0
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def safe_put(item) -> bool:
            """put that re-checks stop so an abandoned consumer (early break,
            exception) never leaves this thread parked on a full queue."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # three-stage pipeline: item futures for up to prefetch+1
            # batches run ahead in the worker pool, this thread collates
            # completed batches in order, and a dedicated transfer thread
            # owns device_put — H2D waits (which can be long when transfers
            # serialize behind an executing step) overlap with decoding
            from collections import deque

            pool = None
            # batch fast path: packed datasets assemble a whole collated
            # batch in one vectorized gather (data/packed.py) — one pool
            # task per batch instead of B item futures + a collate pass
            use_batch = hasattr(self.dataset, "get_batch")
            try:
                pool, ephemeral = self._get_pool()
                with ThreadPoolExecutor(max_workers=1) as xfer:
                    ahead = self.prefetch + 1
                    inflight: deque = deque()  # (item_futures, true_count)
                    pending: deque = deque()  # device_put futures
                    # item occurrence counter (per-item seeds); offset past
                    # skipped batches so a mid-epoch resume reproduces the
                    # continuous run's augmentation seeds
                    pos = skipped * self.batch_size

                    def submit_batch(idxs) -> None:
                        nonlocal pos
                        true_count = len(idxs)
                        if self.pad_last and true_count < self.batch_size:
                            idxs = np.concatenate(
                                [idxs, np.repeat(idxs[-1:], self.batch_size - true_count)]
                            )
                        if use_batch:
                            # one seed per batch: pak augmentations replay
                            # exactly across restarts/resumes on EITHER
                            # backend (get_batch uses a local Generator)
                            seed = int(
                                np.random.SeedSequence(
                                    (self.seed % (2**31), self.epoch, pos)
                                ).generate_state(1)[0]
                            )
                            fn = (
                                self.dataset.get_batch if ephemeral else _worker_getbatch
                            )
                            futs = [pool.submit(fn, idxs, seed)]
                            pos += len(idxs)
                        elif ephemeral:  # thread pool: shared in-process RNG
                            futs = [
                                pool.submit(self.dataset.__getitem__, int(i))
                                for i in idxs
                            ]
                        else:
                            futs = []
                            for i in idxs:
                                # SeedSequence mixing: a linear formula
                                # collides across epochs on large datasets
                                # (epoch e pos p == epoch e+1 pos p-const),
                                # replaying augmentation streams
                                seed = int(
                                    np.random.SeedSequence(
                                        # mask: SeedSequence rejects negative
                                        # entropy (configs may use seed=-1)
                                        (self.seed % (2**31), self.epoch, pos)
                                    ).generate_state(1)[0]
                                )
                                futs.append(
                                    pool.submit(_worker_getitem, int(i), seed)
                                )
                                pos += 1
                        inflight.append((futs, true_count))

                    def drain(limit: int) -> bool:
                        while len(pending) > limit:
                            if not safe_put(pending.popleft().result()):
                                return False
                        return True

                    it = iter(batches)
                    for idxs in list(itertools.islice(it, ahead)):
                        submit_batch(idxs)
                    while inflight:
                        if stop.is_set():
                            return
                        futs, true_count = inflight.popleft()
                        items = [f.result() for f in futs]
                        nxt = next(it, None)
                        if nxt is not None:
                            submit_batch(nxt)
                        batch = items[0] if use_batch else self.collate_fn(items)
                        if self.pad_last and isinstance(batch, dict):
                            batch["_count"] = true_count
                        if self.device_put_fn is not None:
                            pending.append(xfer.submit(self.device_put_fn, batch))
                            if not drain(1):
                                return
                        elif not safe_put(batch):
                            return
                    if not drain(0):
                        return
            except Exception as e:  # surface worker errors to the consumer
                safe_put(e)
            finally:
                if pool is not None and pool is not self._proc_pool:
                    pool.shutdown(wait=False, cancel_futures=True)
                safe_put(StopIteration)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                with span("vipant.data.wait"):
                    item = out_q.get()
                if item is StopIteration:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
