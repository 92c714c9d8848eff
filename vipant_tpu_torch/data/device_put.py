"""The loader's host-to-device step: collated NumPy batches to the card
through pinned staging buffers, on a side CUDA stream.

Counterpart of the JAX trainer's ``loader_device_put``
(``vipant_tpu/train/trainer.py:142-164``), which the loader runs in its
transfer thread so the copy overlaps decoding and the step before. Here:

1. :meth:`PinnedDevicePut.__call__` (the transfer thread) copies each array
   into a pinned host buffer, issues a ``non_blocking`` copy to the card on
   a side stream and records an event after it;
2. :meth:`PinnedDevicePut.wait` (the consumer, before the step) makes the
   compute stream wait on that event and calls ``record_stream`` on each
   device tensor, so the caching allocator does not hand its memory out
   again while a step queued on the compute stream still reads it.

A pinned buffer is written again only after the copy that last read it has
finished (its event is synchronised first), so a later batch never
overwrites a buffer whose copy is still in flight. Nothing falls back: a
failed pinned allocation or copy raises. On the CPU (``device="cpu"``, as
the tests run) the arrays become CPU tensors and there is no stream.
"""

from __future__ import annotations

import threading
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..utils import require_device, span

# pinned buffer sets in turn: a set is reused only after its copy finished,
# so more slots only let more copies run ahead
SLOTS = 3


class PinnedDevicePut:
    """``device_put_fn`` of :class:`..loader.DataLoader` for the arrays under
    ``keys``; the card by default (raises without one)."""

    def __init__(self, keys: Sequence[str], device="cuda"):
        self.keys = tuple(keys)
        self.device = require_device(device, "PinnedDevicePut")
        self.on_card = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.on_card else None
        self._slots = [{"bufs": {}, "done": None} for _ in range(SLOTS)]
        self._next = 0
        self._lock = threading.Lock()  # a loader's epochs may overlap in their transfer threads

    def _pinned(self, slot: Dict, key: str, arr: np.ndarray) -> torch.Tensor:
        buf = slot["bufs"].get(key)
        shape, dtype = tuple(arr.shape), torch.from_numpy(arr).dtype
        if buf is None or tuple(buf.shape) != shape or buf.dtype != dtype:
            buf = slot["bufs"][key] = torch.empty(shape, dtype=dtype, pin_memory=True)
        return buf

    def __call__(self, batch: Dict) -> Dict:
        with span("vipant.data.put"):
            return self._put(batch)

    def _put(self, batch: Dict) -> Dict:
        arrays = {k: np.ascontiguousarray(batch[k]) for k in self.keys}
        if not self.on_card:
            batch.update({k: torch.from_numpy(a) for k, a in arrays.items()})
            return batch
        with self._lock:
            slot = self._slots[self._next]
            self._next = (self._next + 1) % SLOTS
            if slot["done"] is not None:
                slot["done"].synchronize()  # the copy that last read these buffers
            out = {}
            with torch.cuda.stream(self.stream):
                for k, a in arrays.items():
                    host = self._pinned(slot, k, a)
                    host.numpy()[...] = a
                    out[k] = host.to(self.device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.stream)
            slot["done"] = done
        batch.update(out)
        batch["_copied"] = done
        return batch

    def wait(self, batch: Dict) -> Tuple[torch.Tensor, ...]:
        """The batch's tensors under ``keys``, ready for work queued on the
        current stream after this call."""
        done = batch.pop("_copied", None)
        tensors = tuple(batch[k] for k in self.keys)
        if done is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(done)
            for t in tensors:
                t.record_stream(compute)
        return tensors
