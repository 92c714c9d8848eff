#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card at the cell's
own size, several seeds in one process.

    python3 perfbench/control.py --workload <cell> --mode <mode> --seeds 11,12,13

Modes:

- ``program``: the program's numbers, as a run's check computes them (the
  lower readings): a training cell's set-up steps, or a serving cell's
  ``check_requests`` requests, each against the reference;
- ``fp8``: the control of a training cell, the reference put in the
  program's place in float8 e4m3 (every product's operands and every
  activation the program keeps in bfloat16: the precision below the
  configuration's);
- ``half``: a training cell's half-batch fault, the reference put in the
  program's place with its loss over the first half of the batch;
- ``int8``: the control of a serving cell, the program's own int8 engine.

Each seed prints one JSON line. The benchmark's runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell: dict, mode: str, seed: int, device) -> dict:
    """The check's numbers of one seed in ``mode``."""
    from perfbench.drivers import common, embed, train_step

    mix = cell["mix"]
    if mix["driver"] == "train_step":
        if mode == "program":
            sess = train_step.Session(cell, seed, device)
            got = sess.readings(int(mix["check_steps"]))
            sess.close()
        elif mode in ("fp8", "half"):
            got = train_step.reference_readings(
                cell, seed, device, precision="fp8" if mode == "fp8" else "fp32",
                rows=int(mix["batch"]) // 2 if mode == "half" else None)
        else:
            raise ValueError(f"mode {mode!r} is not a training cell's")
        return common.train_numbers(got, train_step.reference_readings(cell, seed, device))
    if mode not in ("program", "int8"):
        raise ValueError(f"mode {mode!r} is not a serving cell's")
    sess = embed.Session(cell, seed, device, quantize="int8" if mode == "int8" else "")
    answers = []
    for _ in range(int(mix["check_requests"])):
        slot, out, _ = sess.request()
        answers.append((slot, out))
    sess.close()
    return {"worst_row_gap": embed.worst_row_gap(cell, seed, device, answers)}


def main(argv=None, device=None, patch=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True, choices=("program", "fp8", "half", "int8"))
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    from perfbench.harness import device as dev
    from perfbench.harness import spec

    dev.fix_caches(ROOT)
    cell = spec.cell(args.workload)
    if patch is not None:
        patch(cell)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("perfbench control: needs a CUDA device", file=sys.stderr)
            return 2
        device = "cuda:0"
    card = dev.smi() if torch.device(device).type == "cuda" else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = {"workload": args.workload, "mode": args.mode, "seed": seed, "card": card,
                "numbers": readings(cell, args.mode, seed, device),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
