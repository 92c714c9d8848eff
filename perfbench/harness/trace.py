"""The traced window: ``torch.profiler`` over a few steps or requests of the
timed path, reduced to what the per-layer metrics read.

- device busy time: every kernel, copy and fill interval on the card merged
  on the timeline, clipped to the window (the harness's ``perfbench.window``
  span, which ends on a synchronize);
- host launches: the CUDA runtime's and driver's launch calls, on every host
  thread; device kernels: the kernels the card ran. A launch without its
  kernel means the profiler lost events, and the caller takes the window
  again;
- host-to-device copies' device time;
- device time by operation name, and the idle gaps labelled by what the
  host's main thread was doing: the innermost ``perfbench.*`` span of the
  harness and the innermost host operation around the gap's middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

SMALL_GAP_NS = 20_000  # gaps shorter than this are launch latency between kernels
TOP = 10
WINDOW = "perfbench.window"


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{what}_us")() * 1000)


def events(prof) -> List[Tuple[str, bool, int, int, int]]:
    """(name, on the device, start ns, end ns, host thread) of every event
    of the trace; the card's copies of the harness's spans (user
    annotations) left out."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type().name == "CUDA"
        if dev and (e.is_user_annotation() or e.name().startswith("perfbench.")):
            continue
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        out.append((e.name(), dev, start, end, 0 if dev else int(e.start_thread_id())))
    return out


def _merge(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, t in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


def _innermost(spans, starts, mid: int, limit: int = 2000) -> str:
    i = bisect.bisect_right(starts, mid) - 1
    for j in range(i, max(i - limit, -1), -1):
        if spans[j][2] >= mid:
            return spans[j][0]
    return ""


def reduce(evs) -> Dict[str, object]:
    """The window's numbers from :func:`events`' list."""
    win = [e for e in evs if e[0] == WINDOW and not e[1]]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    _, _, ws, we, main = win[-1]
    device = [(n, max(s, ws), min(t, we)) for n, d, s, t, _ in evs if d and t > ws and s < we]
    busy_spans = _merge([(s, t) for _, s, t in device if t > s])
    busy = sum(t - s for s, t in busy_spans)
    by_name: Dict[str, int] = defaultdict(int)
    for n, s, t in device:
        by_name[n] += t - s
    kernels = sum(1 for n, _, _ in device if not n.startswith(("Memcpy", "Memset")))
    h2d = sum(t - s for n, s, t in device if n.startswith("Memcpy") and "HtoD" in n)
    host = [e for e in evs if not e[1] and ws <= e[2] <= we]
    launches = sum(1 for e in host if e[0].startswith(("cudaLaunch", "cuLaunch")))
    main_host = sorted(((n, s, t) for n, _, s, t, th in host if th == main and n != WINDOW),
                       key=lambda e: e[1])
    spans = [e for e in main_host if e[0].startswith("perfbench.")]
    ops = [e for e in main_host if not e[0].startswith("perfbench.")]
    span_starts, op_starts = [e[1] for e in spans], [e[1] for e in ops]
    gaps: Dict[str, int] = defaultdict(int)
    edges = [ws] + [x for st in busy_spans for x in st] + [we]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        if b - a < SMALL_GAP_NS:
            gaps["between kernels (< 20 us)"] += b - a
            continue
        mid = (a + b) // 2
        label = (_innermost(spans, span_starts, mid) or "outside the harness's spans") + " / " + (
            _innermost(ops, op_starts, mid) or "python")
        gaps[label] += b - a
    return {
        "window_s": (we - ws) / 1e9, "busy_s": busy / 1e9, "kernels": kernels, "launches": launches,
        "h2d_s": h2d / 1e9,
        "device_ops": [[n, d / 1e9] for n, d in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[n, d / 1e9] for n, d in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def trace_window(torch, body: Callable[[], None], device, attempts: int = 3,
                 say=print) -> Dict[str, object]:
    """``body()`` (the timed path's steps) under the profiler, inside the
    ``perfbench.window`` span, which ends on a synchronize; taken again, up to
    ``attempts`` times in all, while the card's kernels are fewer than the
    host's launches. ``windows`` is how many were taken. On the CPU (the
    tests) only the host is traced."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    best = None
    for k in range(1, attempts + 1):
        sync()
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                body()
                sync()
        red = reduce(events(prof))
        say(f"trace: window {k}: {red['launches']} host launches, {red['kernels']} device kernels")
        if best is None or red["kernels"] / max(red["launches"], 1) > best["kernels"] / max(best["launches"], 1):
            best = red
        if red["kernels"] >= red["launches"]:
            break
    best["windows"] = k
    say(f"trace: took {k} window(s)")
    return best
