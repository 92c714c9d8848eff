"""Small helpers of the port: the registry, what the entry points accept as
a device and as a configuration, where a run's files go, and the trainer's
seeding, logging, meters and phase timers (the port's own copies of ``vipant_tpu/utils/__init__.py``'s
``seed_all_rng``, ``setup_logger``, ``AverageMeter``, ``PhaseTimer`` and
``numel``; ``numel`` counts a mapping or sequence of tensors here), and the
spans of the profiler's timeline (:mod:`.trace`)."""

from __future__ import annotations

import logging
import os
import random
import sys
import tempfile
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from .cfg import as_config
from .device import require_device
from .registry import Registry
from .trace import span, timed_span

__all__ = [
    "AverageMeter",
    "PhaseTimer",
    "Registry",
    "as_config",
    "numel",
    "require_device",
    "run_root",
    "seed_all_rng",
    "setup_logger",
    "span",
    "timed_span",
]


# the values of alias_root, model_root and profile.dir in config/defaults/default.yaml, and of
# running.clip_model_root in config/defaults/running/*.yaml
SHIPPED_PATHS = ("/tmp/vipant", "/tmp/vipant_profile", "/tmp/clip")


def run_root(path) -> str:
    """The directory a config's ``alias_root``, ``model_root``,
    ``profile.dir`` or ``running.clip_model_root`` names: a shipped default
    moves under the process's temp directory (``TMPDIR``), so runs with
    their own ``TMPDIR`` never share files; any other path as given."""
    path = str(path)
    if path in SHIPPED_PATHS:
        return os.path.join(tempfile.gettempdir(), os.path.basename(path))
    return path


def seed_all_rng(seed: int) -> None:
    """Seed python/numpy RNGs. Torch generators are seeded explicitly from `seed`."""
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))


def setup_logger(
    output_dir: Optional[str] = None,
    rank: int = 0,
    verbose: bool = True,
    name: str = "vipant",
) -> logging.Logger:
    """Rank-aware logger: console on rank 0, per-rank file everywhere."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG if verbose else logging.INFO)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
    fmt = logging.Formatter(
        "%(asctime)s %(levelname).1s %(name)s: %(message)s", datefmt="%m/%d %H:%M:%S"
    )
    if rank == 0:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setFormatter(fmt)
        logger.addHandler(ch)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, f"train_{rank}.out"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger


class AverageMeter:
    """Running mean over a sliding window of recent values."""

    def __init__(self, window: int = 0):
        self.window = window
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self._hist = []

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        if self.window > 0:
            self._hist.append((val, n))
            while len(self._hist) > self.window:
                v, m = self._hist.pop(0)
                self.sum -= v * m
                self.count -= m

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase (data/model/report...)."""

    def __init__(self):
        self._acc: Dict[str, float] = defaultdict(float)
        self._t0: Dict[str, float] = {}

    def start(self, phase: str) -> None:
        self._t0[phase] = time.perf_counter()

    def stop(self, phase: str) -> float:
        dt = time.perf_counter() - self._t0.pop(phase)
        self._acc[phase] += dt
        return dt

    def __getitem__(self, phase: str) -> float:
        return self._acc[phase]

    def summary(self) -> str:
        return " ".join(f"{k} {v:.2f}s" for k, v in sorted(self._acc.items()))

    def reset(self) -> None:
        self._acc.clear()
        self._t0.clear()


def numel(tensors) -> int:
    """Total number of scalars in a mapping or sequence of tensors (dedup by id)."""
    seen = set()
    total = 0
    for t in tensors.values() if hasattr(tensors, "values") else tensors:
        if id(t) in seen:
            continue
        seen.add(id(t))
        total += int(t.numel())
    return total
