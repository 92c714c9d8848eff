"""The program's spans in a traced window: each ``vipant.*`` range's host
time, and the card's idle time split among them.

From :func:`perfbench.harness.trace.events`' list:

- ``host_s``: each span name's inclusive host time clipped to the window,
  on any thread (the transfer thread's ``vipant.data.put`` too, where the
  profiler records every thread);
- ``idle_s``: every idle interval of the window (no kernel, copy or fill on
  the card), of any length, split exactly among the innermost ``vipant.*``
  span of the window's main thread over each part of it; a part that no
  such span covers goes under ``""``. The ``idle_s`` of all names sum to
  the window's idle time.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

from .trace import WINDOW, _merge

PREFIX = "vipant."


def _innermost_segments(spans: List[Tuple[str, int, int]], ws: int, we: int) -> List[Tuple[int, int, str]]:
    """[ws, we) cut into (start, end, innermost span's name or "") pieces;
    ``spans`` nest (one thread's ranges)."""
    segs: List[Tuple[int, int, str]] = []
    stack: List[Tuple[str, int]] = []
    cur = ws

    def emit(upto: int) -> None:
        nonlocal cur
        if upto > cur:
            segs.append((cur, upto, stack[-1][0] if stack else ""))
            cur = upto

    for name, s, t in sorted(spans, key=lambda e: (e[1], -e[2])):
        s, t = max(s, ws), min(t, we)
        if t <= s:
            continue
        while stack and stack[-1][1] <= s:
            emit(stack[-1][1])
            stack.pop()
        emit(s)
        stack.append((name, min(t, stack[-1][1]) if stack else t))
    while stack:
        emit(stack[-1][1])
        stack.pop()
    emit(we)
    return segs


def split(evs) -> Dict[str, Dict[str, float]]:
    """``{name: {"count", "host_s", "idle_s"}}`` over the window's
    ``vipant.*`` spans, and ``""`` for idle time outside them."""
    win = [e for e in evs if e[0] == WINDOW and not e[1]]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    _, _, ws, we, main = win[-1]
    busy = _merge([(max(s, ws), min(t, we)) for _, d, s, t, _ in evs if d and t > ws and s < we])
    out: Dict[str, Dict[str, float]] = defaultdict(lambda: {"count": 0, "host_s": 0.0, "idle_s": 0.0})
    mine = []
    for n, d, s, t, th in evs:
        if d or not n.startswith(PREFIX) or t <= ws or s >= we:
            continue
        out[n]["count"] += 1
        out[n]["host_s"] += (min(t, we) - max(s, ws)) / 1e9
        if th == main:
            mine.append((n, s, t))
    edges = [ws] + [x for st in busy for x in st] + [we]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    segs = _innermost_segments(mine, ws, we)
    i = 0
    for a, b in idle:  # both lists sorted and disjoint: one pass
        while i < len(segs) and segs[i][1] <= a:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < b:
            s, t, name = segs[j]
            out[name]["idle_s"] += (min(t, b) - max(s, a)) / 1e9
            j += 1
    return dict(out)

