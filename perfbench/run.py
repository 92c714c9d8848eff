#!/usr/bin/env python3
"""One run of one cell of ``BENCHMARK.json`` on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, the kernel library, weights and
inputs from the seed, the warm-up) counts as ``setup_s``; the window then
measures for ``--seconds``. With ``--trace 1`` the run also takes a
``torch.profiler`` window and reports the cell's per-layer metrics and the
breakdown; with ``--trace 0`` its end-to-end metrics. Every run then checks
what the timed path produced against the plain reference and prints each
compared number beside its limit, as the last lines of standard error and
under ``check``, the last key of the result.

The last line of standard output is the result. There is none, and the exit
code is not 0, when the card or the cell's count of cards is missing, when
the program cannot be imported, or when a module of JAX or of the JAX
package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None, device=None, patch=None) -> int:
    """The command. ``device`` and ``patch`` are the tests' entry: a run on
    the CPU, without the look for a card, of the cell as ``patch(cell)``
    leaves it (smaller sizes)."""
    args = parse(argv)
    from perfbench.harness import device as dev
    from perfbench.harness import spec

    dev.fix_caches(ROOT)
    cell = spec.cell(args.workload)
    if patch is not None:
        patch(cell)
    import torch

    chips = int(cell["chips"])
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < chips:
            say(f"perfbench: {args.workload} needs {chips} CUDA device(s); torch sees {have}")
            return 2
        device = "cuda:0"
        torch.cuda.set_device(0)
    on_card = torch.device(device).type == "cuda"
    card = dev.smi() if on_card else "cpu"
    say(f"perfbench: {args.workload} seed {args.seed} on {card}")
    rec = spec.driver(cell["mix"]["driver"]).run(cell, args.seed, args.seconds, bool(args.trace), device,
                                                 T_START, say=say)
    found = dev.loaded_forbidden()
    if found:
        say(f"perfbench: modules of JAX or of the JAX package are loaded: {', '.join(found)}")
        return 3
    metrics = spec.metric_values(cell["metrics"]["per_layer" if args.trace else "end_to_end"], rec)
    result = {"correct": bool(rec["correct"]), "attempted": int(rec["attempted"]),
              "failed": int(rec["failed"]), "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                         "count": chips if on_card else 1,
                         "memory_peak_bytes": int(rec["memory_peak_bytes"])}}
    if rec.get("trace"):
        t = rec["trace"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    result["card"] = card
    result["check"] = rec["check"]
    for name, c in rec["check"].items():
        say(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
