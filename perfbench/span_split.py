#!/usr/bin/env python3
"""One traced run of one cell, as ``perfbench/run.py --trace 1`` makes it,
with the program's ``vipant.*`` spans split out of its traced window
(:mod:`perfbench.harness.spans`), every host thread recorded (the loader's
transfer thread too).

    python3 perfbench/span_split.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout. Standard output holds the run's own line, as
``run.py`` prints it, then, last, ``{"workload", "seed", "units",
"window_ms", "busy_ms", "spans": {name: {"count", "host_ms", "idle_ms"}}}``
with every time per traced step or request; ``idle_ms`` under ``""`` is the
card's idle time outside every span of the main thread. The run's line does
not carry these readings (PERF.md §7); this is how they are read.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run  # noqa: E402  (its set-up clock starts here)


def main(argv=None, device=None, patch=None) -> int:
    """The command; ``device`` and ``patch`` as in :func:`perfbench.run.main`."""
    import torch
    import torch.profiler

    from perfbench.harness import spans, spec, trace

    argv = list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"]
    args = run.parse(argv)
    drv = spec.driver(spec.cell(args.workload)["mix"]["driver"])
    real = {"profile": torch.profiler.profile, "reduce": trace.reduce, "run": drv.run}
    got = {}

    def profile(*a, **k):
        k["experimental_config"] = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        return real["profile"](*a, **k)

    def reduce(evs):
        red = real["reduce"](evs)
        red["spans"] = spans.split(evs)
        return red

    def run_cell(*a, **k):
        got["rec"] = real["run"](*a, **k)
        return got["rec"]

    torch.profiler.profile, trace.reduce, drv.run = profile, reduce, run_cell
    try:
        rc = run.main(argv, device=device, patch=patch)
    finally:
        torch.profiler.profile, trace.reduce, drv.run = real["profile"], real["reduce"], real["run"]
    if rc or "rec" not in got:
        return rc or 1
    t = got["rec"]["trace"]
    n = t["units"]
    per = lambda s: s * 1e3 / n  # noqa: E731
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "units": n, "window_ms": per(t["window_s"]),
        "busy_ms": per(t["busy_s"]),
        "spans": {k: {"count": v["count"], "host_ms": per(v["host_s"]), "idle_ms": per(v["idle_s"])}
                  for k, v in sorted(t["spans"].items())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
