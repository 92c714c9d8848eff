"""The VA epoch loop's steady-state time against the number of loader
workers, on one card: ``chip_smoke.py`` phase 14's synthetic index, its
trainer (the flagship config, B = 64, process workers, SpecAugment on, the
loss read every step) and its timed window (``chip_smoke._timed_epoch``),
at each worker count, for the npz source, the wav source (the host fbank)
and the dev source (phase 16's device frontend: int16 waveforms and uint8
frames ship, ``chip_smoke.DEV_SHIP``)::

    python vipant_tpu_torch/experiments/loop_workers.py [npz counts] [wav counts] [dev counts]

Counts are comma-separated (default ``2,4,6,8``, ``4,6`` and ``2,4,8``; an
empty list skips its source). Prints, per run, ms per step of the loop,
clips/s, the data-wait share, the median ``train_step`` call in the window
beside the step alone, and each step's (wait, call) ms. The npz index is its
split read 3 times (12 steps) and the dev index 4 times (16 steps), each
with the loader's last ``2 * prefetch + 2`` batches left out of the window;
the wav index is its split once (4 steps).
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
    given = sys.argv[1:4]
    counts = [[int(n) for n in a.split(",") if n]
              for a in given + ["2,4,6,8", "4,6", "2,4,8"][len(given):]]
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    data = tempfile.mkdtemp(prefix="vipant_workers_")
    try:
        cs.write_synthetic_va(data, "train", cs.LOOP_TRAIN, npz_name="npz_train", seed=0)
        for index, repeat in (("npz_train", cs.LOOP_NPZ_REPEAT), ("train", cs.LOOP_DEV_REPEAT)):
            with open(os.path.join(data, f"{index}.jsonl")) as f, \
                    open(os.path.join(data, f"{index}_long.jsonl"), "w") as g:
                g.writelines(f.readlines() * repeat)
        print(f"host cpu_count {os.cpu_count()}, batch {cs.LOOP_B}")
        for source, label, nums, extra in (("npz_train_long", "npz", counts[0], []),
                                           ("train", "wav", counts[1], []),
                                           ("train_long", "dev", counts[2], cs.DEV_SHIP)):
            for n in nums:
                tr = cs._loop_trainer(torch, data, os.path.join(data, f"run_{label}_{n}"),
                                      f"running.data_name={source}", "running.eval_name=",
                                      "running.save_epoch=False", "running.save_rate=1000000000",
                                      f"num_proc={n}", *extra)
                tail = 2 * tr.loader.prefetch + 2 if label != "wav" else 0
                t0 = time.perf_counter()
                ms, clips, share, steps, series = cs._timed_epoch(torch, tr, 0, tail)
                batch = next(iter(tr.loader))
                args = tr.device_put.wait(batch)
                tr.close()
                alone = cs.cuda_ms(torch, lambda: tr.train_step(*args, audio_len=batch.get("audio_len")),
                                   5, 2)
                call = float(np.median([c for _, c in series[1:steps + 1]]))
                print(f"{label} source, {n} workers: {ms:.2f} ms per step, {clips:.1f} clips/s, "
                      f"data-wait share {100 * share:.1f} % over {steps} steps; train_step call "
                      f"median {call:.0f} ms in the window, the step alone {alone:.2f} ms; epoch "
                      f"{time.perf_counter() - t0:.1f} s; (wait, call) ms {series}", flush=True)
                del tr, args, batch
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(data, ignore_errors=True)


if __name__ == "__main__":  # the loader's spawned workers import this module again
    main()
