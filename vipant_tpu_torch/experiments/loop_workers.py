"""The VA epoch loop's steady-state time against the number of loader
workers, on one card: ``chip_smoke.py`` phase 14's synthetic index, its
trainer (the flagship config, B = 64, process workers, SpecAugment on, the
loss read every step) and its timed window (``chip_smoke._timed_epoch``),
at each worker count, for the npz and the wav source::

    python vipant_tpu_torch/experiments/loop_workers.py [npz counts] [wav counts]

Counts are comma-separated (default ``2,4,6,8`` and ``4,6``). Prints, per
run, ms per step of the loop, clips/s, the data-wait share, the median
``train_step`` call in the window beside the step alone, and each step's
(wait, call) ms. The npz index is its split read 6 times (24 steps, the
last 6 left out of the window); the wav index is its split once (4 steps).
"""

import os
import shutil
import sys
import tempfile
import time


def main() -> None:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from vipant_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("loop_workers: needs a CUDA device")
    counts = [[int(n) for n in a.split(",")] for a in (sys.argv[1:] + ["2,4,6,8", "4,6"][len(sys.argv) - 1:])]
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    data = tempfile.mkdtemp(prefix="vipant_workers_")
    try:
        cs.write_synthetic_va(data, "train", cs.LOOP_TRAIN, npz_name="npz_train", seed=0)
        with open(os.path.join(data, "npz_train.jsonl")) as f, \
                open(os.path.join(data, "npz_train_long.jsonl"), "w") as g:
            g.writelines(f.readlines() * cs.LOOP_NPZ_REPEAT)
        print(f"host cpu_count {os.cpu_count()}, batch {cs.LOOP_B}")
        for source, label, nums in (("npz_train_long", "npz", counts[0]), ("train", "wav", counts[1])):
            for n in nums:
                tr = cs._loop_trainer(torch, data, os.path.join(data, f"run_{label}_{n}"),
                                      f"running.data_name={source}", "running.eval_name=",
                                      "running.save_epoch=False", "running.save_rate=1000000000",
                                      f"num_proc={n}")
                tail = 2 * tr.loader.prefetch + 2 if label == "npz" else 0
                t0 = time.perf_counter()
                ms, clips, share, steps, series = cs._timed_epoch(torch, tr, 0, tail)
                args = tr.device_put.wait(next(iter(tr.loader)))
                tr.close()
                alone = cs.cuda_ms(torch, lambda: tr.train_step(*args), 5, 2)
                call = float(np.median([c for _, c in series[1:steps + 1]]))
                print(f"{label} source, {n} workers: {ms:.2f} ms per step, {clips:.1f} clips/s, "
                      f"data-wait share {100 * share:.1f} % over {steps} steps; train_step call "
                      f"median {call:.0f} ms in the window, the step alone {alone:.2f} ms; epoch "
                      f"{time.perf_counter() - t0:.1f} s; (wait, call) ms {series}", flush=True)
                del tr, args
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(data, ignore_errors=True)


if __name__ == "__main__":  # the loader's spawned workers import this module again
    main()
