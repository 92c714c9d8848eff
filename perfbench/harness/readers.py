"""The arithmetic that the metric readers (``perfbench/metrics/<name>.py``)
share. Each takes a run's record, and the end-to-end ones the side they read
(``train`` or ``serve``), and returns None where the record has nothing for
it: another side's run, or a run without its traced window."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..work.counts import PEAK_FLOPS


def _traced(rec: dict) -> Optional[dict]:
    """The run's traced window, where the card was busy in it."""
    t = rec.get("trace")
    return t if t and t["busy_s"] > 0 else None


def rate(rec: dict, kind: str) -> Optional[float]:
    """Clips completed in the window over its seconds."""
    if rec.get("kind") != kind:
        return None
    return rec["window"]["clips"] / rec["window"]["seconds"]


def latency_percentile(rec: dict, kind: str, q: float) -> Optional[float]:
    if rec.get("kind") != kind or not rec["window"].get("latencies_ms"):
        return None
    return float(np.percentile(np.asarray(rec["window"]["latencies_ms"]), q))


def per_unit(rec: dict, key: str, scale: float = 1.0) -> Optional[float]:
    """A traced count or time over the traced steps or requests."""
    t = _traced(rec)
    return None if t is None else t[key] * scale / t["units"]


def idle_pct(rec: dict) -> Optional[float]:
    """The share of a step's or a request's time with nothing on the card:
    the traced units' device busy time against the untraced window's time
    per unit (the profiler's own host work stretches the traced window)."""
    t = _traced(rec)
    if t is None:
        return None
    w = rec["window"]
    return 100.0 * (1.0 - (t["busy_s"] / t["units"]) / (w["seconds"] / w["units"]))


def roofline_pct(rec: dict) -> Optional[float]:
    """The least time of the traced steps' required work over the card's
    busy time in them."""
    t = _traced(rec)
    return None if t is None else 100.0 * rec["work"]["least_s_per_unit"] * t["units"] / t["busy_s"]


def mfu_pct(rec: dict) -> Optional[float]:
    """The window's model product FLOPs per second (profiler off) over the
    bf16 peak."""
    if _traced(rec) is None:
        return None
    w = rec["window"]
    return 100.0 * rec["work"]["flops_per_unit"] * w["units"] / w["seconds"] / PEAK_FLOPS["bf16"]


def peak_gib(rec: dict) -> Optional[float]:
    """The device memory peak of the window (the allocator's, reset at its
    start)."""
    if _traced(rec) is None or not rec.get("peak_window_bytes"):
        return None
    return rec["peak_window_bytes"] / 2 ** 30
